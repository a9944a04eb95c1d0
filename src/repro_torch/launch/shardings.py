"""Cell assembly on torch: (architecture x input shape x mesh) -> a
traceable step.

The twin of the JAX package's ``repro.launch.shardings``.  ``build_cell``
returns the step of one cell with this rank's abstract inputs (tensors
on the ``meta`` device, parameters as the rank's shards):

  * ``train_*``   -> the full train step (fwd + bwd + AdamW update),
  * ``prefill_*`` -> the prefill function (prompt -> primed KV cache),
  * ``decode_*`` / ``long_*`` -> one serve step with a seq_len cache,

in the reference's production numerics (bf16 parameters and compute,
f32 optimizer moments).  Where the reference lowers the cell through
GSPMD, ``Cell.lower`` traces it: :func:`repro_torch.core.psg.trace` over
fake tensors under the cell's rules, giving the FX graph and the PSG
whose Comm vertices are the rank's collectives.  A mesh may span ranks
that this process does not run: trace under
:func:`repro_torch.launch.mesh.fake_process_group`.

Partition specs are the reference's (``shardings_from_axes``,
``train_state_shardings``); the storage is the port's: weights are split
on ``model``, and across ``data`` only under the ``gather_weights``
option (FSDP storage, gathered at use).  ``seq_shard`` puts the residual
stream's seq on ``model`` between blocks (sequence parallelism, where the
sequence divides the axis).  Where the rules split the decode cache's
positions (a GQA model whose KV heads do not divide the model axis;
long-context serving over the batch axes) a rank's cache is its slice of
them, as the model makes it (``cache_specs``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES
from repro_torch.configs import get as get_config
from repro_torch.configs import shape_applicable
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.core import psg as psg_lib
from repro_torch.distributed import axes as ax
from repro_torch.models.api import ModelBundle, build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.tree import tree_map
from repro_torch.training.trainer import TrainState, make_train_step

Pytree = Any


# ---------------------------------------------------------------------------
# axes-tree -> PartitionSpec-tree
# ---------------------------------------------------------------------------

def _is_axes_leaf(x) -> bool:
    return x is None or (
        isinstance(x, tuple) and not hasattr(x, "_fields")
        and all(a is None or isinstance(a, str) for a in x))


def _zip_axes(axes_tree: Pytree, abstract_tree: Pytree, fn: Callable
              ) -> Pytree:
    """``fn(axes, tensor)`` over an axes tree and its congruent tree of
    tensors (dicts and NamedTuples)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, abstract_tree)
    if isinstance(axes_tree, dict):
        return {k: _zip_axes(axes_tree[k], abstract_tree[k], fn)
                for k in axes_tree}
    return type(abstract_tree)(*(_zip_axes(a, t, fn) for a, t in
                                 zip(axes_tree, abstract_tree)))


def shardings_from_axes(axes_tree: Pytree, abstract_tree: Pytree,
                        mesh, rules=None) -> Pytree:
    """The PartitionSpec of each leaf of ``abstract_tree`` from its
    logical axes in ``axes_tree``."""
    return _zip_axes(axes_tree, abstract_tree, lambda axs, t: (
        ax.PartitionSpec() if axs is None
        else ax.spec_for(axs, t.shape, mesh, rules)))


def _local(axes_tree: Pytree, abstract_tree: Pytree, mesh, rules
           ) -> Pytree:
    """This rank's part of abstract inputs: each dim divided by the size
    of the mesh axes its spec puts it on."""
    sizes = ax.axis_sizes(mesh)

    def local(axs, t):
        shape = list(t.shape)
        spec = ax.spec_for(axs or (), t.shape, mesh, rules)
        for d, part in enumerate(spec):
            for a in () if part is None else (
                    (part,) if isinstance(part, str) else part):
                shape[d] //= sizes[a]
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return _zip_axes(axes_tree, abstract_tree, local)


def rules_for_shape(shape: ShapeConfig, cfg: Optional[ArchConfig] = None,
                    mesh=None) -> Dict[str, Any]:
    """The reference's rules for a cell: long-context serving puts the
    cache's seq dim on the batch axes; a GQA model whose KV heads do not
    divide the model axis puts it on ``model`` for prefill and decode."""
    rules = dict(ax.DEFAULT_RULES)
    if shape.seq_len >= 262_144:
        rules["kv_seq"] = ("pod", "data")
    elif (cfg is not None and mesh is not None
          and shape.kind in ("prefill", "decode") and cfg.n_kv_heads):
        if cfg.n_kv_heads % ax.axis_sizes(mesh)["model"] != 0:
            rules["kv_seq"] = "model"
            rules["kv_heads"] = None
    return rules


# ---------------------------------------------------------------------------
# abstract state + shardings per cell kind
# ---------------------------------------------------------------------------

def abstract_train_state(model: ModelBundle) -> TrainState:
    """The train state on the ``meta`` device (this rank's shards under
    the active rules), f32 moments."""
    params = model.abstract_params()

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    def i32():
        return torch.empty((), dtype=torch.int32, device="meta")

    return TrainState(params=params,
                      opt=AdamWState(step=i32(), mu=tree_map(f32, params),
                                     nu=tree_map(f32, params)),
                      residual=None, step=i32())


def train_state_shardings(model: ModelBundle, mesh, rules=None
                          ) -> TrainState:
    """The train state's PartitionSpecs: parameters by their logical
    axes, moments mirroring them, scalars replicated."""
    with ax.use_rules(mesh, rules):
        specs = model.param_partition_specs()
    scalar = ax.PartitionSpec()
    return TrainState(params=specs,
                      opt=AdamWState(step=scalar, mu=specs, nu=specs),
                      residual=None, step=scalar)


@dataclasses.dataclass
class Cell:
    """Everything needed to trace one (arch x shape x mesh) combination."""
    arch: str
    shape: ShapeConfig
    kind: str                      # train | prefill | decode
    fn: Callable
    args: Tuple[Pytree, ...]       # this rank's abstract inputs
    mesh: Any
    rules: Dict[str, Any]
    model: ModelBundle
    options: Dict[str, bool] = dataclasses.field(default_factory=dict)

    def lower(self) -> psg_lib.Traced:
        """The cell's step traced over fake tensors: its FX graph and its
        PSG (Comm vertices for the rank's collectives)."""
        with ax.use_rules(self.mesh, self.rules, self.options):
            return psg_lib.trace(self.fn, *self.args)


def build_cell(arch: str, shape_name: str, mesh, *,
               run: Optional[RunConfig] = None,
               cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None,
               options: Optional[Dict[str, bool]] = None) -> Cell:
    """Assemble the traceable step for one cell (raises if inapplicable).

    ``options``: ``moe_sort`` picks the sort dispatch for MoE training;
    ``gather_weights`` stores the parameters (and the optimizer's moments)
    split on ``data`` too, gathered at use (ZeRO-3); ``seq_shard`` splits
    the residual stream's seq on ``model`` between blocks (sequence
    parallelism).  ``shape`` overrides the ``SHAPES[shape_name]`` lookup
    (smoke-scale cells)."""
    shape = SHAPES[shape_name] if shape is None else shape
    cfg = cfg if cfg is not None else get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {why}")
    options = dict(options or {})
    # production numerics: bf16 params/compute, f32 optimizer moments
    cfg = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    run = run or RunConfig(arch=arch, shape=shape_name)
    rules = rules_for_shape(shape, cfg, mesh)
    if options.get("seq_shard"):
        # Megatron-style sequence parallelism, as the reference: only the
        # residual stream between blocks is split on seq over 'model'
        rules["res_seq"] = "model"
    model = build_model(cfg, device="cpu", moe_strategy=(
        "sort" if options.get("moe_sort") else "einsum"))
    extra_ctx = cfg.frontend_len if cfg.family == "vlm" else 0

    with ax.use_rules(mesh, rules, options):
        inputs = model.input_specs(shape)
        in_ax = model.input_logical_axes(shape)
        if shape.kind == "train":
            lr_fn = warmup_cosine(run.learning_rate, run.warmup_steps,
                                  run.total_steps)
            batch = _local(in_ax, inputs, mesh, rules)
            return Cell(arch, shape, "train",
                        make_train_step(model, run, lr_fn),
                        (abstract_train_state(model), batch), mesh, rules,
                        model, options)
        params = model.abstract_params()
        if shape.kind == "prefill":
            max_len = shape.seq_len + extra_ctx

            def prefill_fn(p, b):
                return model.prefill(p, b, max_len)

            return Cell(arch, shape, "prefill", prefill_fn,
                        (params, _local(in_ax, inputs, mesh, rules)), mesh,
                        rules, model, options)

        def serve_step(p, cache, tok):
            return model.decode_step(p, cache, tok)

        # the rank's cache from the model (a packed SSD conv state is not
        # a slice of the whole one), on the batch rows of its tokens
        tokens = _local(in_ax["tokens"], inputs["tokens"], mesh, rules)
        cache = model.cache_specs(tokens.shape[0], shape.seq_len)
        return Cell(arch, shape, "decode", serve_step,
                    (params, cache, tokens), mesh, rules, model, options)

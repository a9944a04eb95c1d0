"""Trainer on torch: the train step, its state, and the training loop.

``make_train_step`` is the JAX package's pure step as a torch function
``(state, batch) -> (state, metrics)``: nothing is written in place, so
the old state stays valid and :func:`repro_torch.core.psg.trace` can
trace the step.  Gradients come from ``torch.autograd.grad`` of the
model's ``train_loss`` (through ``use_kernels=False``: the kernels have
no backward, as in the reference).

Data parallelism is the step's own, not a compiler's: under
:func:`repro_torch.distributed.axes.use_rules` with a mesh, the step
averages its gradients, its loss and its MoE metrics over the mesh's
batch axes ('pod', 'data') with one bucketed all-reduce over their group,
which the traced PSG holds as a Comm vertex at its root.  It does so at
every scale, one rank included, so the PSGs of a scaling series have the
same vertices.  Under a ``model`` axis each rank's bucket holds its own
parameter shards; the model's own collectives (tensor-parallel layers,
the MoE load-balance means) sit inside the layer loop.  Under
``gather_weights`` the leaves a rank stores split on ``data`` stay out of
the bucket: the reduce-scatter that ends their gathers' backward has
summed them over ``data`` already (over a pod axis they have an
all-reduce of their own).  Without a mesh it runs no collective.

``Trainer`` is the twin of the reference's: data, the step, checkpoints
and the ScalAna hooks (the sampled ``GraphProfiler``, per-step wall
times, the host spans of :mod:`repro_torch.core.spans` a ``train``
call, an injected per-rank delay for case studies).  Its checkpoints
are the reference's, logically unsharded: under a ``model`` axis every
parameter, moment and residual leaf is gathered whole before a save
(:func:`whole_state`), one rank writes, and a restore loads the whole
leaves and keeps the rank's shards (:func:`local_tree`), so a checkpoint
moves between meshes, one process and the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES
from repro_torch.configs import get as get_config
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.core import spans
from repro_torch.core.profiler import GraphProfiler
from repro_torch.core.psg import scan
from repro_torch.data import make_dataset
from repro_torch.distributed import axes as ax
from repro_torch.distributed.axes import active_mesh, placements_for, use_rules
from repro_torch.models.api import ModelBundle, build_model
from repro_torch.models.params import Specs, _walk, param_specs_tree
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compress import error_feedback_update, init_residual
from repro_torch.optim.tree import Tree, leaves, tree_map, unflatten_like

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Tree
    opt: AdamWState
    residual: Optional[Tree]      # error-feedback residual (or None)
    step: torch.Tensor            # int32 scalar


# step metrics that are means over the rank's tokens: averaged with the
# gradients (the MoE load-balance loss is already global, ``batch_mean``)
DATA_MEAN_METRICS = ("moe_z_loss", "moe_drop_frac")


def _all_reduce_sum(flat: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    flat = funcol.all_reduce(flat, "sum", group)
    return flat.wait() if isinstance(flat, funcol.AsyncCollectiveTensor) \
        else flat


def data_parallel_mean(loss: torch.Tensor, grads: Tree, mesh,
                       metrics: Optional[Dict[str, torch.Tensor]] = None,
                       specs: Optional[Specs] = None
                       ) -> Tuple[torch.Tensor, Tree,
                                  Dict[str, torch.Tensor]]:
    """The loss, gradients and :data:`DATA_MEAN_METRICS` averaged over
    ``mesh``'s batch axes ('pod', 'data'): one all-reduce of one float32
    bucket (every gradient leaf, the loss, then the metrics) over their
    group (made when the mesh was installed), so the step has exactly one
    data-side collective and its loss is the global batch's mean.
    Summed, then divided by the axes' size: a sum is the reduction every
    backend carries on CUDA tensors, Gloo's too (the backend of several
    ranks on one card).  Under a ``model`` axis the leaves are the rank's
    shards.  ``specs`` (the model's) marks the leaves stored split on
    ``data`` under ``gather_weights``: they stay out of the bucket, as
    their backward summed them over ``data`` already; over a ``pod`` axis
    they are summed by an all-reduce of their own; then divided by the
    same size."""
    metrics = dict(metrics or {})
    names = [k for k in DATA_MEAN_METRICS if k in metrics]
    gl = leaves(grads)
    split = [False] * len(gl) if specs is None else [
        ax.data_dim(sp.axes, sp.shape) is not None for _, sp in _walk(specs)]
    group, n = ax.batch_group()
    flat = torch.cat([g.reshape(-1).float() for g, s in zip(gl, split)
                      if not s]
                     + [loss.reshape(1).float()]
                     + [metrics[k].reshape(1).float() for k in names])
    flat = _all_reduce_sum(flat, group)
    flat.div_(n)                     # the sum is ours: one bucket, not two
    own = [g for g, s in zip(gl, split) if s]
    if own:
        pod = torch.cat([g.reshape(-1).float() for g in own])
        if "pod" in ax.axis_sizes(mesh):
            pod = _all_reduce_sum(pod, mesh.get_group("pod"))
        pod = pod / n
    out, at, at_own = [], 0, 0
    for g, s in zip(gl, split):
        if s:
            part, at_own = pod[at_own:at_own + g.numel()], \
                at_own + g.numel()
        else:
            part, at = flat[at:at + g.numel()], at + g.numel()
        out.append(part.reshape(g.shape).to(g.dtype))
    for i, k in enumerate(names):
        metrics[k] = flat[at + 1 + i].to(metrics[k].dtype)
    return flat[at].to(loss.dtype), unflatten_like(grads, out), metrics


def model_parallel_norm(tree: Tree, specs: Specs) -> torch.Tensor:
    """The global norm of a tree of this rank's shards (congruent with
    ``specs``): the squares of the leaves split on ``model`` summed over
    its ranks, of those split on ``data`` (``gather_weights``) over its
    ranks, the whole leaves' counted once."""
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    for leaf, (_, spec) in zip(leaves(tree), _walk(specs)):
        key = tuple(a for _, a, _ in ax.storage_splits(spec.axes,
                                                         spec.shape))
        sq = torch.sum(torch.square(leaf.float()))
        sums[key] = sums[key] + sq if key in sums else sq
    total = None
    for key, sq in sums.items():
        if "data" in key:
            sq = ax.all_reduce_sum(sq, ax.axis_group("data"))
        if "model" in key:
            sq = ax.reduce_from_model(sq)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def make_train_step(model: ModelBundle, run: RunConfig,
                    lr_fn: Callable[[torch.Tensor], torch.Tensor]
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the pure train-step function (grad-accum + AdamW [+ EF-int8])."""
    nmicro = max(int(run.microbatch), 1)
    compress = run.grad_compress

    def single_grads(params: Tree, batch: Batch):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = model.train_loss(ps, batch)
            grads = torch.autograd.grad(loss, leaves(ps))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten_like(params, list(grads)))

    def accum_grads(params: Tree, batch: Batch):
        def split(x):
            b = x.shape[0]
            if b % nmicro:
                raise ValueError(f"batch {b} does not split into "
                                 f"{nmicro} microbatches")
            return x.reshape((nmicro, b // nmicro) + x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        zero = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

        def body(carry, mb):
            acc, lsum = carry
            loss, metrics, grads = single_grads(params, mb)
            acc = tree_map(lambda a, g: a + g.float() / nmicro, acc, grads)
            return (acc, lsum + loss / nmicro), metrics

        lzero = torch.zeros((), dtype=torch.float32,
                            device=leaves(params)[0].device)
        (grads, loss), metrics = scan(
            body, (zero, lzero),
            [{k: v[i] for k, v in micro.items()} for i in range(nmicro)],
            name="microbatches")
        return loss, metrics[-1], grads

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        fn = accum_grads if nmicro > 1 else single_grads
        loss, metrics, grads = fn(state.params, batch)
        mesh = active_mesh()
        if mesh is not None:
            loss, grads, metrics = data_parallel_mean(loss, grads, mesh,
                                                      metrics, model.specs)
        residual = state.residual
        if compress and residual is not None:
            grads, residual = error_feedback_update(grads, residual)
        lr = lr_fn(state.step)
        norm = {}
        if mesh is not None and ax.sharded_storage():
            norm["norm_fn"] = lambda t: model_parallel_norm(t, model.specs)
        params, opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, lr=lr,
            weight_decay=run.weight_decay, **norm)
        # "loss" last: under grad accumulation `metrics` carries the last
        # microbatch's values, but the step loss is the microbatch mean
        out = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(params=params, opt=opt, residual=residual,
                          step=state.step + 1), out

    return train_step


# ---------------------------------------------------------------------------
# Checkpoint trees
# ---------------------------------------------------------------------------

def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """``state`` as a plain tree of numpy arrays whose paths are the
    manifest keys the JAX package writes for its ``TrainState``
    (``params/...``, ``opt/{step,mu,nu}/...``, ``residual/...``, ``step``;
    no leaf for a ``None`` residual)."""
    def host(t):
        return tree_map(lambda x: x.detach().cpu().numpy(), t)

    tree = {"params": host(state.params),
            "opt": {"step": host(state.opt.step), "mu": host(state.opt.mu),
                    "nu": host(state.opt.nu)},
            "step": host(state.step)}
    if state.residual is not None:
        tree["residual"] = host(state.residual)
    return tree


def state_from_tree(tree: Dict[str, Any], like: TrainState) -> TrainState:
    """The inverse of :func:`state_to_tree`, on ``like``'s devices and
    dtypes."""
    def dev(arrs, ref):
        return tree_map(lambda a, r: torch.from_numpy(np.asarray(a)).to(
            device=r.device, dtype=r.dtype), arrs, ref)

    return TrainState(
        params=dev(tree["params"], like.params),
        opt=AdamWState(step=dev(tree["opt"]["step"], like.opt.step),
                       mu=dev(tree["opt"]["mu"], like.opt.mu),
                       nu=dev(tree["opt"]["nu"], like.opt.nu)),
        residual=(dev(tree["residual"], like.residual)
                  if like.residual is not None else None),
        step=dev(tree["step"], like.step))


def _map_sharded(tree: Dict[str, Any], specs: Specs, fn) -> Dict[str, Any]:
    """``fn(leaf, spec)`` over the parameter, moment and residual leaves
    of a :func:`state_to_tree` tree (``spec`` the parameter's); the step
    counters as they are."""
    def go(node, sp):
        if isinstance(node, dict):
            return {k: go(node[k], sp[k]) for k in node}
        return fn(node, sp)

    out = dict(tree)
    for k in ("params", "residual"):
        if k in tree:
            out[k] = go(tree[k], specs)
    out["opt"] = {**tree["opt"], "mu": go(tree["opt"]["mu"], specs),
                  "nu": go(tree["opt"]["nu"], specs)}
    return out


def whole_state(state: TrainState, specs: Specs) -> TrainState:
    """``state`` with every leaf split on ``model`` (and on ``data`` under
    ``gather_weights``) gathered whole under the active rules (a
    collective that each rank of the axes joins); the state itself where
    a rank stores every leaf whole."""
    if not ax.sharded_storage():
        return state
    flat = [sp for _, sp in _walk(specs)]

    def whole(tree):
        if tree is None:
            return None
        with torch.no_grad():
            return unflatten_like(tree, [
                ax.gather_shards(t, sp.axes, sp.shape)
                for t, sp in zip(leaves(tree), flat)])

    return TrainState(params=whole(state.params),
                      opt=AdamWState(step=state.opt.step,
                                     mu=whole(state.opt.mu),
                                     nu=whole(state.opt.nu)),
                      residual=whole(state.residual), step=state.step)


def whole_like(tree: Dict[str, Any], specs: Specs) -> Dict[str, Any]:
    """A :func:`state_to_tree` tree of this rank's shards as a template
    of the whole leaves' shapes (zero-stride arrays, no storage): what a
    checkpoint's manifest is checked against."""
    return _map_sharded(tree, specs, lambda a, sp: np.broadcast_to(
        np.zeros((), a.dtype), sp.shape))


def local_tree(tree: Dict[str, Any], specs: Specs) -> Dict[str, Any]:
    """This rank's shards, under the active rules, of a tree of whole
    leaves (a restored checkpoint)."""
    return _map_sharded(tree, specs, lambda a, sp: ax.local_shard(
        torch.from_numpy(np.asarray(a)), sp.axes).numpy())


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

def to_device(np_batch: Dict[str, np.ndarray], device: torch.device
              ) -> Batch:
    """A numpy batch of the data pipeline on ``device`` (token ids as
    int64, the index type of the models' lookups)."""
    return {k: torch.from_numpy(v).to(
        device=device, dtype=torch.long if v.dtype.kind in "iu" else None)
        for k, v in np_batch.items()}


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """End-to-end training loop (data + step + ckpt + ScalAna).

    ``device`` is ``cuda`` unless the caller asks for ``cpu``; it raises
    without a card.  With a ``mesh`` (a DeviceMesh over the process
    group, :func:`repro_torch.launch.mesh.make_host_mesh`) each rank
    reads its shard of the global batch and the step averages over the
    batch axes; ``options`` are :func:`use_rules`' (``gather_weights``:
    parameters, moments and residual stored split on ``data`` too).
    Every rank joins a checkpoint's gather; the rank at
    coordinate 0 of every mesh axis writes it, and the others wait at a
    barrier after the last save of :meth:`train` until it is committed."""

    def __init__(self, run: RunConfig, *, mesh=None, rules=None,
                 options: Optional[Dict[str, bool]] = None,
                 arch_cfg: Optional[ArchConfig] = None,
                 shape: Optional[ShapeConfig] = None,
                 global_batch: Optional[int] = None,
                 inject_delay: Optional[Dict[int, float]] = None,
                 device: torch.device | str = "cuda"):
        self.run = run
        self.mesh = mesh
        self.rules = rules
        self.options = dict(options or {})
        self.device = torch.device(device)
        self.cfg = arch_cfg if arch_cfg is not None else get_config(run.arch)
        self.shape = shape if shape is not None else SHAPES[run.shape]
        self.model = build_model(self.cfg, device=self.device)
        self.lr_fn = warmup_cosine(run.learning_rate, run.warmup_steps,
                                   run.total_steps)
        self.train_step_fn = make_train_step(self.model, run, self.lr_fn)
        self.dataset = make_dataset(self.cfg, self.shape, seed=run.seed,
                                    global_batch=global_batch)
        if mesh is not None:
            self.dataset = self.dataset.shard(*ax.batch_coord(mesh))
        self.ckpt = (CheckpointManager(run.checkpoint_dir,
                                       keep=run.keep_checkpoints)
                     if run.checkpoint_dir else None)
        # ScalAna channels
        self.profiler: Optional[GraphProfiler] = None
        self.step_wall_times: list = []    # the `trainer.step` spans
        self.metrics_log: list = []
        self.span_log: list = []           # a span total a train() call
        # case-study hook: {rank: extra seconds} host-side injected delay
        self.inject_delay = dict(inject_delay or {})

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        with self._rules():              # a rank's shards under a model axis
            params = self.model.init(self.model.generator(
                self.run.seed if seed is None else seed))
        residual = init_residual(params) if self.run.grad_compress else None
        return TrainState(params=params, opt=adamw_init(params),
                          residual=residual,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def state_shardings(self, state: TrainState) -> Optional[TrainState]:
        """``(DeviceMesh, placements)`` per leaf of ``state``: parameters by
        their logical axes under the rules, moments mirroring them,
        scalars replicated.  Like the reference's, ``train`` does not
        apply it."""
        if self.mesh is None:
            return None
        with self._rules():
            specs = param_specs_tree(self.model.specs)

        def like_params():
            return tree_map(lambda spec: (self.mesh, placements_for(
                spec, self.mesh)), specs)

        scalar = (self.mesh, placements_for((), self.mesh))
        return TrainState(
            params=like_params(),
            opt=AdamWState(step=scalar, mu=like_params(), nu=like_params()),
            residual=like_params() if state.residual is not None else None,
            step=scalar)

    # ------------------------------------------------------------------
    def _rules(self):
        return (use_rules(self.mesh, self.rules, self.options)
                if self.mesh is not None else contextlib.nullcontext())

    def _writes(self) -> bool:
        """Whether this rank writes the checkpoints (coordinate 0 of every
        mesh axis; the one process without a mesh)."""
        return self.mesh is None or not any(self.mesh.get_coordinate())

    def _save(self, step: int, state: TrainState, last: bool) -> None:
        """Checkpoint ``state`` whole at ``step`` (the gather under the
        rules, on every rank); ``last`` writes it blocking and holds every
        rank at a barrier until it is committed."""
        with spans.span("trainer.checkpoint"):
            with self._rules():
                whole = whole_state(state, self.model.specs)
            if self._writes():
                self.ckpt.save(step, state_to_tree(whole), blocking=last)
            del whole
            if (last and self.mesh is not None
                    and dist.get_world_size() > 1):
                dist.barrier()

    def restore(self, state: TrainState):
        """(step, state) from the latest checkpoint, its whole leaves cut
        to this rank's shards (``state`` gives the structure, devices and
        dtypes); None when there is none."""
        specs = self.model.specs
        like = whole_like(state_to_tree(state), specs)
        restored = self.ckpt.restore_latest(like)
        if restored is None:
            return None
        step, tree, _ = restored
        with self._rules():
            return step, state_from_tree(local_tree(tree, specs), state)

    def _put_batch(self, np_batch: Dict[str, np.ndarray]) -> Batch:
        return to_device(np_batch, self.device)

    def enable_scalana(self, state: TrainState, example_batch: Batch) -> None:
        """Build PSG + profiler over the traced train step."""
        with self._rules():
            self.profiler = GraphProfiler(
                self.train_step_fn, (state, example_batch),
                sample_every=self.run.scalana_sample_every,
                max_loop_depth=self.run.max_loop_depth)

    # ------------------------------------------------------------------
    def train(self, num_steps: Optional[int] = None,
              state: Optional[TrainState] = None,
              resume: bool = True,
              step_timeout_s: float = 0.0) -> TrainState:
        """Run ``num_steps`` steps; the call's span totals (gc pauses
        included) go to :attr:`span_log` at its end.  The loop runs in
        this frame: a frame around it would hold the call's first state
        to the end."""
        with spans.collect() as totals, spans.span("trainer.train"):
            num_steps = num_steps or self.run.total_steps
            start_step = 0
            if state is None:
                state = self.init_state()
                if resume and self.ckpt is not None:
                    restored = self.restore(state)
                    if restored is not None:
                        start_step, state = restored

            if self.run.scalana and self.profiler is None:
                batch0 = self._put_batch(self.dataset.batch(start_step))
                self.enable_scalana(state, batch0)

            step_fn = (self.profiler.step if self.profiler is not None
                       else self.train_step_fn)
            rank = dist.get_rank() if dist.is_initialized() else 0
            with self._rules():
                for i in range(start_step, start_step + num_steps):
                    with spans.span("trainer.batch"):
                        np_batch = self.dataset.batch(i)
                    with spans.span("trainer.put_batch"):
                        batch = self._put_batch(np_batch)
                    with spans.span("trainer.step") as step:
                        if self.inject_delay.get(rank):
                            time.sleep(self.inject_delay[rank])  # stragglers
                        state, metrics = step_fn(state, batch)
                        _fence(self.device)
                    dt = step.seconds
                    self.step_wall_times.append(dt)
                    with spans.span("trainer.readback"):
                        if step_timeout_s and dt > step_timeout_s:
                            # straggler mitigation: surface, don't hang
                            self.metrics_log.append({"step": i,
                                                     "timeout": dt})
                        self.metrics_log.append(
                            {"step": i,
                             "loss": float(metrics["loss"]),
                             "grad_norm": float(metrics.get("grad_norm",
                                                            0.0)),
                             "wall_s": dt})
                    if (self.ckpt is not None and self.run.checkpoint_every
                            and (i + 1) % self.run.checkpoint_every == 0):
                        self._save(i + 1, state, last=False)
            if self.ckpt is not None:
                self._save(start_step + num_steps, state, last=True)
        self.span_log.append(spans.record("trainer.train", totals))
        return state

    # ------------------------------------------------------------------
    def scalana_artifacts(self):
        """(contracted PSG, per-vertex perf vectors, storage bytes)."""
        if self.profiler is None:
            return None
        return (self.profiler.psg, self.profiler.perf_vectors(),
                self.profiler.storage_bytes())

"""Logical-axis sharding rules on torch.

The twin of the JAX package's ``repro.distributed.axes``.  Models are
written mesh-agnostic against *logical* axis names ('batch', 'embed',
'q_features', 'vocab', 'experts', ...).  A launcher installs a rule table
and a mesh with ``use_rules``; ``spec_for`` resolves a value's
``PartitionSpec`` and ``sharding_for`` its DTensor placements.  Without
an active context everything is a no-op, so unit tests and single-device
runs never touch the mesh machinery.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or, where only the axis sizes matter (resolving specs for a mesh that
this process does not span), a mapping from axis name to size: the
counterpart of ``jax.sharding.AbstractMesh``.

Rules map logical name -> mesh axis (str), tuple of mesh axes, or None.
A logical dim is only sharded if its size is divisible by the mesh axis
product (padding is legal but wasteful; we opt out explicitly, e.g.
yi-6b's 4 KV heads on a 16-way model axis stay replicated).

The port's launch layer is data-parallel: the train step averages its
gradients over the ``data`` axis itself (``training/trainer.py``).  So
``logical_constraint`` and ``weight_constraint`` are identities without
a mesh, and under a mesh whose only axes above size 1 are batch axes
('pod', 'data'), where every activation is the rank's batch shard.
Under a ``model`` axis above 1 they raise: tensor parallelism is
ROADMAP Queue 1 item 10b.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Rule = Union[str, Tuple[str, ...], None]

# Default logical rules for the production 2D/3D mesh.
DEFAULT_RULES: Dict[str, Rule] = {
    "batch": ("pod", "data"),
    "seq": None,
    "res_seq": None,           # residual-stream seq; "model" under SP (§Perf it.3)
    "kv_seq": None,            # overridden to "data" for long-context serving
    "embed": "data",           # FSDP dimension for params
    "q_features": "model",     # n_heads * head_dim
    "kv_features": "model",    # n_kv_heads * head_dim
    "heads": "model",          # per-head activation axis
    "kv_heads": "model",
    "mlp": "model",            # d_ff
    "vocab": "model",
    "experts": "model",        # EP
    "ssm_inner": "model",      # d_inner of SSD blocks
    "ssm_heads": "model",
    "ssm_pdim": "model",       # SSD head_dim fallback when H % model != 0
    "layers": None,
    "frontend": None,
    "state": None,
    "conv": None,
}

BATCH_AXES = ("pod", "data")   # mesh axes that split only the batch


class PartitionSpec(tuple):
    """One entry per dim: a mesh axis, a tuple of mesh axes, or None
    (replicated); trailing Nones dropped, as ``jax.sharding.PartitionSpec``
    is built by ``spec_for``."""

    def __new__(cls, *parts: Rule) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Any = None
        self.rules: Dict[str, Rule] = {}
        self.options: Dict[str, bool] = {}


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[Dict[str, Rule]] = None,
              options: Optional[Dict[str, bool]] = None):
    """Install mesh + logical rules (+ optimization options) for the region.

    Options (all default off): ``gather_weights`` — the FSDP gather-at-use
    point of ``weight_constraint``."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.options)
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)
    _CTX.options = dict(options or {})
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.options = prev


def active_mesh():
    return _CTX.mesh


def option(name: str) -> bool:
    return bool(_CTX.options.get(name, False))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a name -> size mapping."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return dict(zip(names, (int(n) for n in mesh.shape)))


def require_data_parallel(mesh, what: str) -> None:
    """Raise unless every axis of ``mesh`` above size 1 splits only the
    batch: the port has no tensor-parallel path yet."""
    wide = [a for a, n in axis_sizes(mesh).items()
            if n > 1 and a not in BATCH_AXES]
    if wide:
        raise NotImplementedError(
            f"{what} under mesh axes {wide} above size 1: tensor "
            "parallelism on torch is ROADMAP Queue 1 item 10b")


def weight_constraint(w: torch.Tensor, *logical_axes: Optional[str]
                      ) -> torch.Tensor:
    """FSDP gather-at-use point for a weight matrix: a no-op unless the
    ``gather_weights`` option is on, then ``logical_constraint`` with the
    weight's 'embed' (FSDP-storage) dim replicated."""
    if not option("gather_weights"):
        return w
    axes = tuple(None if a == "embed" else a for a in logical_axes)
    return logical_constraint(w, *axes)


def _mesh_axes_of(rule: Rule, sizes: Mapping[str, int]) -> Tuple[str, ...]:
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in axes if a in sizes)


def resolve_axis(logical: Optional[str], dim_size: int, mesh=None,
                 rules: Optional[Dict[str, Rule]] = None) -> Rule:
    """Mesh axes for one logical dim, or None (incl. non-divisible opt-out)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules if rules is not None else _CTX.rules
    if mesh is None or logical is None:
        return None
    sizes = axis_sizes(mesh)
    axes = _mesh_axes_of(rules.get(logical), sizes)
    if not axes:
        return None
    product = 1
    for a in axes:
        product *= sizes[a]
    if dim_size % product != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def spec_for(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh=None, rules: Optional[Dict[str, Rule]] = None
             ) -> PartitionSpec:
    """PartitionSpec for a value with the given logical axes and shape."""
    used: set = set()
    parts: List[Rule] = []
    for name, size in zip(logical_axes, shape):
        ax = resolve_axis(name, size, mesh, rules)
        # one mesh axis may shard at most one dim
        flat = () if ax is None else ((ax,) if isinstance(ax, str)
                                      else tuple(ax))
        if any(a in used for a in flat):
            ax = None
            flat = ()
        used.update(flat)
        parts.append(ax)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def placements_for(spec: PartitionSpec, mesh) -> Tuple[Any, ...]:
    """DTensor placements (one per mesh dim) of ``spec``: ``Shard(d)`` on
    each mesh dim that shards tensor dim ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out: List[Any] = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        for a in () if ax is None else ((ax,) if isinstance(ax, str) else ax):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def logical_constraint(x: torch.Tensor, *logical_axes: Optional[str]
                       ) -> torch.Tensor:
    """The sharding hint via logical names: a no-op without a mesh and
    under a data-parallel mesh; raises under a model axis above 1."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    require_data_parallel(mesh, "logical_constraint")
    return x


def sharding_for(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh=None, rules: Optional[Dict[str, Rule]] = None
                 ) -> Tuple[Any, Tuple[Any, ...]]:
    """``(DeviceMesh, placements)`` of a value with these logical axes."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None or isinstance(mesh, Mapping):
        raise ValueError("sharding_for requires a DeviceMesh")
    return mesh, placements_for(spec_for(logical_axes, shape, mesh, rules),
                                mesh)

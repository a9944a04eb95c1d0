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

Distribution is explicit, not a compiler's.  A rank holds the local
shards of its parameters: the slice that ``spec_for`` gives its
coordinate on the ``model`` axis (the ``data`` part of a spec, FSDP
storage, is not applied: a weight stays whole across ``data`` ranks).
The models run on those shards and call the collectives below where
GSPMD would insert them for the reference, Megatron's column/row split:

* :func:`copy_to_model` — identity forward, all-reduce over ``model``
  backward, where a replicated activation enters column-parallel weights;
* :func:`reduce_from_model` — all-reduce over ``model`` forward, identity
  backward, where row-parallel partial sums leave;
* :func:`gather_from_model` — all-gather over ``model`` forward,
  reduce-scatter backward, for a weight sharded where its use needs it
  whole (the MoE router, K/V weights split inside a head);
* :func:`sum_over_model` — an all-reduce over ``model`` forward and
  backward, for a partial sum every rank uses whole (the SSD block's
  gate-norm sum of squares over its heads);
* :func:`batch_mean` — a mean over the batch axes ('pod', 'data') whose
  backward passes the cotangent through (the MoE load-balance means).

Each is a functional collective, so a traced step holds it as a Comm
vertex with its ``file:line`` here.  ``logical_constraint`` is the
reference's hint on an activation: under these local shards it has
nothing to move, so it is an identity, except for a sequence dim that
the rules put on ``model`` (sequence parallelism, ROADMAP Queue 1 item
10b), for which it raises.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.core.psg import own_source

# torch 2.11 has only the ``*_tensor`` names; later releases add the
# ``*_single`` names and deprecate the others: call whichever is there
_all_gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
_reduce_scatter = getattr(funcol, "reduce_scatter_single",
                          funcol.reduce_scatter_tensor)

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


class _Ctx:
    """The installed mesh, rules and options: process-wide, not per
    thread, because on a card the autograd engine runs a backward, and a
    checkpoint's recompute of the forward, on a thread of its own."""

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


def model_size(mesh=None) -> int:
    """Size of the ``model`` axis of ``mesh`` (the active mesh when None);
    1 without one."""
    mesh = mesh if mesh is not None else _CTX.mesh
    return 1 if mesh is None else axis_sizes(mesh).get("model", 1)


def weight_constraint(w: torch.Tensor, *logical_axes: Optional[str]
                      ) -> torch.Tensor:
    """FSDP gather-at-use point for a weight matrix: a no-op unless the
    ``gather_weights`` option is on.  Weights are not stored sharded on
    'data' (FSDP storage is ROADMAP Queue 1 item 10b), so that option
    raises under a mesh."""
    if not option("gather_weights"):
        return w
    if _CTX.mesh is not None:
        raise NotImplementedError(
            "gather_weights: FSDP storage of 'embed' on 'data' on torch is "
            "ROADMAP Queue 1 item 10b")
    return w


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
    """The reference's sharding hint via logical names.  A rank's tensors
    are its local shards already, so there is nothing to move: the
    identity without a mesh, under a data-parallel mesh, and under a
    ``model`` axis above 1, except for a sequence dim that the rules put
    on ``model`` (``seq_shard``), for which it raises."""
    mesh = _CTX.mesh
    if mesh is None or model_size(mesh) == 1:
        return x
    for name in logical_axes:
        if name is None:
            continue
        on_model = "model" in _mesh_axes_of(_CTX.rules.get(name),
                                            axis_sizes(mesh))
        if on_model and name.endswith("seq"):
            raise NotImplementedError(
                f"logical_constraint: {name!r} on the model axis on torch "
                "is ROADMAP Queue 1 item 10b")
    return x


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def model_dim(logical_axes: Sequence[Optional[str]], shape: Sequence[int]
              ) -> Optional[int]:
    """The dim of a value with these logical axes and global ``shape``
    that the active rules shard on a ``model`` axis above 1, or None
    (the value is whole on every ``model`` rank)."""
    mesh = _CTX.mesh
    if model_size(mesh) == 1:
        return None
    for d, ax in enumerate(spec_for(logical_axes, shape, mesh)):
        flat = () if ax is None else ((ax,) if isinstance(ax, str) else ax)
        if "model" in flat:
            if len(flat) > 1:
                raise NotImplementedError(
                    f"{tuple(logical_axes)}: a dim split over {flat} on "
                    "torch is ROADMAP Queue 1 item 10b")
            return d
    return None


def model_rank() -> int:
    """This process's coordinate on the ``model`` axis (0 without one)."""
    if model_size() == 1:
        return 0
    return _device_mesh(_CTX.mesh).get_local_rank("model")


def local_shape(logical_axes: Sequence[Optional[str]],
                shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of a rank's shard of a value of global ``shape``."""
    d = model_dim(logical_axes, shape)
    out = list(shape)
    if d is not None:
        out[d] //= model_size()
    return tuple(out)


def local_shard(t: torch.Tensor, logical_axes: Sequence[Optional[str]],
                rank: Optional[int] = None) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` (``t`` itself when it
    is not split on ``model``); ``rank`` picks another ``model``
    coordinate's (under rules on a mesh given by its axis sizes)."""
    d = model_dim(logical_axes, t.shape)
    if d is None:
        return t
    n = t.shape[d] // model_size()
    r = model_rank() if rank is None else rank
    return t.narrow(d, r * n, n).contiguous()


def gather_shards(t: torch.Tensor, logical_axes: Sequence[Optional[str]],
                  shape: Sequence[int]) -> torch.Tensor:
    """The whole tensor of global ``shape`` from every rank's shard ``t``
    (an all-gather over ``model``; ``t`` itself when not split)."""
    d = model_dim(logical_axes, shape)
    if d is None:
        return t
    return _GatherFromModel.apply(t, d)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _device_mesh(mesh):
    if mesh is None or isinstance(mesh, Mapping):
        raise ValueError("a collective needs a DeviceMesh, not axis sizes")
    return mesh


def _done(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _model_group():
    return _device_mesh(_CTX.mesh).get_group("model")


# Each collective is called where its kind is (own_source: its line is
# the Comm vertex's source in the backward and a recompute too); a
# backward runs over the group its forward ran over.

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.group = _model_group()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with own_source():
            return _done(funcol.all_reduce(g, "sum", ctx.group))


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        with own_source():
            return _done(funcol.all_reduce(x, "sum", _model_group()))

    @staticmethod
    def backward(ctx, g):
        return g


def _all_reduce_only(t: torch.Tensor, group) -> bool:
    """Gloo has no all-gather or reduce-scatter of CUDA tensors (the ranks
    of one card): there they are all-reduces of the zero-padded shards
    and of the whole tensor."""
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        import torch.distributed as dist
        ctx.dim, ctx.group = dim, _model_group()
        x = x.contiguous()
        with own_source():
            if not _all_reduce_only(x, ctx.group):
                return _done(_all_gather(x, dim, ctx.group))
            n, r = x.shape[dim], dist.get_rank(ctx.group)
            shape = list(x.shape)
            shape[dim] = n * dist.get_world_size(ctx.group)
            buf = x.new_zeros(shape)
            buf.narrow(dim, r * n, n).copy_(x)
            return _done(funcol.all_reduce(buf, "sum", ctx.group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous()
        with own_source():
            if not _all_reduce_only(g, ctx.group):
                return _done(_reduce_scatter(g, "sum", ctx.dim,
                                             ctx.group)), None
            whole = _done(funcol.all_reduce(g, "sum", ctx.group))
        n = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return whole.narrow(ctx.dim, dist.get_rank(ctx.group) * n,
                            n).contiguous(), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        with own_source():
            return _done(funcol.all_reduce(x, "sum", group)) / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient summed over ``model``.
    Where a replicated activation (or weight) meets column-parallel work
    whose gradient each rank only has its part of."""
    return _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the sum over ``model`` of the ranks' partial ``x``;
    its gradient passed through (every rank's is the whole one)."""
    return _ReduceFromModel.apply(x)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of the ranks' partial ``x``, its gradient
    summed over ``model`` too: for a partial sum whose total every rank
    uses whole, so that each rank's cotangent of the total is only its
    part of the whole one."""
    return reduce_from_model(copy_to_model(x))


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model`` of ``x`` (no gradient: a
    logsumexp's shift)."""
    with own_source():
        return _done(funcol.all_reduce(x.detach(), "max", _model_group()))


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every ``model`` rank's shard ``x`` concatenated along ``dim``; the
    gradient reduce-scattered back to the shards."""
    return _GatherFromModel.apply(x, dim)


def model_grad_share(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient divided by the ``model`` axis size:
    for a term that every ``model`` rank computes whole but whose
    gradient reaches the parameters through a sum over ``model``
    (:func:`copy_to_model`, :func:`gather_from_model`), so that the sum
    counts it once."""
    m = model_size()
    return x if m == 1 else _ScaleGrad.apply(x, 1.0 / m)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch axes ('pod', 'data') of the active
    mesh: one all-reduce (sum, then divided by the axes' size) under any
    mesh, a batch axis of size 1 included, so traced steps have the same
    vertices at every scale; the identity without a mesh.  The backward
    passes the cotangent through unchanged: every batch rank's loss holds
    the same mean, and the step's data-parallel mean already divides the
    summed gradients by the axes' size."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    dm = _device_mesh(mesh)
    names = [a for a in BATCH_AXES if a in axis_sizes(dm)]
    if not names:
        return x
    if len(names) == 1:       # the group and size without a sub-mesh,
        group = dm.get_group(names[0])   # whose tensor ops a trace sees
        n = axis_sizes(dm)[names[0]]
    else:
        sub = dm[tuple(names)]._flatten()
        group, n = sub.get_group(), sub.size()
    return _BatchMean.apply(x, group, n)


def sharding_for(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh=None, rules: Optional[Dict[str, Rule]] = None
                 ) -> Tuple[Any, Tuple[Any, ...]]:
    """``(DeviceMesh, placements)`` of a value with these logical axes."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None or isinstance(mesh, Mapping):
        raise ValueError("sharding_for requires a DeviceMesh")
    return mesh, placements_for(spec_for(logical_axes, shape, mesh, rules),
                                mesh)

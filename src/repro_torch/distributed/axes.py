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
coordinate on the ``model`` axis and, under the ``gather_weights``
option (FSDP storage), on the ``data`` axis too (:func:`data_dim`: the
``embed`` dim where it divides the axis); without that option a weight
is whole across ``data`` ranks.  The models run on those shards and call
the collectives below where GSPMD would insert them for the reference,
Megatron's column/row split:

* :func:`copy_to_model` — identity forward, all-reduce over ``model``
  backward, where a replicated activation (or weight) enters
  column-parallel work;
* :func:`reduce_from_model` — all-reduce over ``model`` forward, identity
  backward, where row-parallel partial sums leave;
* :func:`gather_from_model` — all-gather over ``model`` forward,
  reduce-scatter backward, for a weight sharded where its use needs it
  whole (the MoE router, K/V weights split inside a head);
* :func:`sum_over_model` — an all-reduce over ``model`` forward and
  backward, for a partial sum every rank uses whole (the SSD block's
  gate-norm sum of squares over its heads);
* :func:`weight_constraint` — the FSDP gather-at-use point: a weight
  stored split on ``data`` all-gathered forward, its gradient
  reduce-scattered backward (the gradient's data reduction);
* :func:`enter_parallel` / :func:`leave_parallel` — an activation's entry
  into column-parallel and exit from row-parallel work: ``copy_to_model``
  and ``reduce_from_model``, or, under sequence parallelism (``seq_shard``:
  the residual stream ``(B, S/m, D)`` between blocks), an all-gather on
  seq (reduce-scatter backward) and a reduce-scatter on seq (all-gather
  backward); :func:`whole_seq` and :func:`own_seq` are the same points
  for work that every ``model`` rank does whole;
* :func:`batch_mean` — a mean over the batch axes ('pod', 'data') whose
  backward passes the cotangent through (the MoE load-balance means).

Each is a functional collective, so a traced step holds it as a Comm
vertex with its ``file:line`` here.  The group of the batch axes is made
when the mesh is installed (``use_rules``), outside any trace.
``logical_constraint`` is the reference's hint on an activation: under
these local shards it has nothing to move, so it is the identity.
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
    """The installed mesh, rules and options, and the group of the mesh's
    batch axes: process-wide, not per thread, because on a card the
    autograd engine runs a backward, and a checkpoint's recompute of the
    forward, on a thread of its own."""

    def __init__(self):
        self.mesh: Any = None
        self.rules: Dict[str, Rule] = {}
        self.options: Dict[str, bool] = {}
        self.batch: Optional[Tuple[Any, int]] = None   # (group, size)


_CTX = _Ctx()


def _batch_group(mesh) -> Optional[Tuple[Any, int]]:
    """(group, size) of the mesh's batch axes ('pod', 'data'), the two
    flattened into one group where both are there; None for axis sizes
    or a mesh without them.  Made when the mesh is installed: flattening
    a sub-mesh runs tensor ops on the mesh, which a trace over fake
    tensors cannot take (and the group is made once, not a step)."""
    if mesh is None or isinstance(mesh, Mapping):
        return None
    sizes = axis_sizes(mesh)
    names = tuple(a for a in BATCH_AXES if a in sizes)
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0]), sizes[names[0]]
    sub = mesh[names]._flatten()
    return sub.get_group(), sub.size()


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[Dict[str, Rule]] = None,
              options: Optional[Dict[str, bool]] = None):
    """Install mesh + logical rules (+ optimization options) for the region.

    Options (all default off): ``gather_weights`` — FSDP storage: a
    rank stores the ``data`` part of each parameter's spec too, and
    :func:`weight_constraint` gathers it at use.  Sequence parallelism is
    a rule (``res_seq`` on ``model``), not an option."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.options, _CTX.batch)
    batch = _batch_group(mesh)
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)
    _CTX.options = dict(options or {})
    _CTX.batch = batch
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.options, _CTX.batch = prev


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


def data_size(mesh=None) -> int:
    """Size of the ``data`` axis of ``mesh`` (the active mesh when None);
    1 without one."""
    mesh = mesh if mesh is not None else _CTX.mesh
    return 1 if mesh is None else axis_sizes(mesh).get("data", 1)


def weight_constraint(w: torch.Tensor, *logical_axes: Optional[str],
                      shape: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
    """FSDP gather-at-use point for a weight: ``w`` whole on ``data``
    where the ``gather_weights`` option stores it split there (the dim
    :func:`data_dim` gives for its logical axes and global ``shape``): an
    all-gather forward, a reduce-scatter of its gradient over ``data``
    backward.  ``w`` itself otherwise."""
    if not option("gather_weights") or _CTX.mesh is None:
        return w
    if shape is None:
        raise ValueError("weight_constraint: under gather_weights a "
                         "weight needs its global shape")
    d = data_dim(logical_axes, shape)
    return w if d is None else _Gather.apply(w, d, axis_group("data"))


def _mesh_axes_of(rule: Rule, sizes: Mapping[str, int]) -> Tuple[str, ...]:
    if rule is None:
        return ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    return tuple(a for a in axes if a in sizes)


def _flat(part: Rule) -> Tuple[str, ...]:
    return () if part is None else ((part,) if isinstance(part, str)
                                    else tuple(part))


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


def rule_axes(logical: str) -> Tuple[Tuple[str, ...], int]:
    """The mesh axes that the active rules map ``logical`` to (those the
    mesh has) and the product of their sizes; ``((), 1)`` without a
    mesh."""
    if _CTX.mesh is None:
        return (), 1
    sizes = axis_sizes(_CTX.mesh)
    axes = _mesh_axes_of(_CTX.rules.get(logical), sizes)
    n = 1
    for a in axes:
        n *= sizes[a]
    return axes, n


def spec_for(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh=None, rules: Optional[Dict[str, Rule]] = None
             ) -> PartitionSpec:
    """PartitionSpec for a value with the given logical axes and shape."""
    used: set = set()
    parts: List[Rule] = []
    for name, size in zip(logical_axes, shape):
        ax = resolve_axis(name, size, mesh, rules)
        # one mesh axis may shard at most one dim
        flat = _flat(ax)
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
        for a in _flat(ax):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def logical_constraint(x: torch.Tensor, *logical_axes: Optional[str]
                       ) -> torch.Tensor:
    """The reference's sharding hint via logical names.  A rank's tensors
    are its local shards already and the models call their collectives
    themselves (a sequence dim on ``model`` included: :func:`enter_parallel`
    and :func:`leave_parallel`), so there is nothing to move: the
    identity."""
    del logical_axes
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
        flat = _flat(ax)
        if "model" in flat:
            if len(flat) > 1:
                raise ValueError(
                    f"{tuple(logical_axes)}: a parameter dim split over "
                    f"{flat}")
            return d
    return None


def data_dim(logical_axes: Sequence[Optional[str]], shape: Sequence[int]
             ) -> Optional[int]:
    """The dim of a parameter with these logical axes and global
    ``shape`` that the ``gather_weights`` option stores split on a
    ``data`` axis above 1 (its ``embed`` dim where that divides the
    axis), or None (the parameter is whole on every ``data`` rank)."""
    mesh = _CTX.mesh
    if not option("gather_weights") or data_size(mesh) == 1:
        return None
    for d, ax in enumerate(spec_for(logical_axes, shape, mesh)):
        if ax == "data":
            return d
    return None


def _coord(axis: str) -> int:
    return _device_mesh(_CTX.mesh).get_local_rank(axis)


def model_rank() -> int:
    """This process's coordinate on the ``model`` axis (0 without one)."""
    return 0 if model_size() == 1 else _coord("model")


def data_rank() -> int:
    """This process's coordinate on the ``data`` axis (0 without one)."""
    return 0 if data_size() == 1 else _coord("data")


def storage_splits(logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int]) -> List[Tuple[int, str, int]]:
    """(dim, mesh axis, its size) of each dim of a value of global
    ``shape`` that a rank stores split: on ``model``, and on ``data``
    under ``gather_weights``."""
    out = []
    d = model_dim(logical_axes, shape)
    if d is not None:
        out.append((d, "model", model_size()))
    d = data_dim(logical_axes, shape)
    if d is not None:
        out.append((d, "data", data_size()))
    return out


def sharded_storage() -> bool:
    """Whether a rank stores any parameter split under the active rules
    (a ``model`` axis above 1, or ``gather_weights`` on a ``data`` axis
    above 1)."""
    return model_size() > 1 or (option("gather_weights")
                                and data_size() > 1)


def batch_coord(mesh) -> Tuple[int, int]:
    """(number of batch shards, this rank's) of a DeviceMesh: its batch
    axes ('pod', 'data') flattened pod-major, as the batch is split."""
    sizes, n, i = axis_sizes(mesh), 1, 0
    for a in BATCH_AXES:
        if a in sizes:
            n, i = n * sizes[a], i * sizes[a] + mesh.get_local_rank(a)
    return n, i


def local_shape(logical_axes: Sequence[Optional[str]],
                shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of a rank's shard of a value of global ``shape``."""
    out = list(shape)
    for d, _, n in storage_splits(logical_axes, shape):
        out[d] //= n
    return tuple(out)


def local_shard(t: torch.Tensor, logical_axes: Sequence[Optional[str]],
                rank: Optional[int] = None) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` (``t`` itself when it
    is split on no axis); ``rank`` picks another ``model`` coordinate's
    (under rules on a mesh given by its axis sizes)."""
    splits = storage_splits(logical_axes, t.shape)
    if not splits:
        return t
    for d, axis, n in splits:
        size = t.shape[d] // n
        r = ((model_rank() if rank is None else rank) if axis == "model"
             else data_rank())
        t = t.narrow(d, r * size, size)
    return t.contiguous()


def gather_shards(t: torch.Tensor, logical_axes: Sequence[Optional[str]],
                  shape: Sequence[int]) -> torch.Tensor:
    """The whole tensor of global ``shape`` from every rank's shard ``t``
    (an all-gather over each axis it is split on; ``t`` itself when it is
    whole)."""
    for d, axis, _ in storage_splits(logical_axes, shape):
        t = _Gather.apply(t, d, axis_group(axis))
    return t


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _device_mesh(mesh):
    if mesh is None or isinstance(mesh, Mapping):
        raise ValueError("a collective needs a DeviceMesh, not axis sizes")
    return mesh


def _done(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def axis_group(axis: str):
    """The process group of this rank's line along mesh axis ``axis``."""
    return _device_mesh(_CTX.mesh).get_group(axis)


def _model_group():
    return axis_group("model")


def batch_group() -> Optional[Tuple[Any, int]]:
    """(group, size) of the active mesh's batch axes ('pod', 'data'),
    made when the mesh was installed; None without them."""
    _device_mesh(_CTX.mesh)
    return _CTX.batch


def group_of(axes: Sequence[str]) -> Tuple[Any, int, int]:
    """(group, size, this rank's index in it) of the mesh axes ``axes``:
    one axis, or the batch axes, flattened pod-major as a dim split over
    them is."""
    dm = _device_mesh(_CTX.mesh)
    sizes = axis_sizes(dm)
    if len(axes) == 1:
        return dm.get_group(axes[0]), sizes[axes[0]], \
            dm.get_local_rank(axes[0])
    if tuple(axes) != tuple(a for a in BATCH_AXES if a in sizes):
        raise ValueError(f"no group of the mesh axes {tuple(axes)}")
    import torch.distributed as dist
    group, n = _CTX.batch
    return group, n, dist.get_rank(group)


# Each collective is called where its kind is (own_source: its line is
# the Comm vertex's source in the backward and a recompute too); a
# backward runs over the group its forward ran over.

def _all_reduce_only(t: torch.Tensor, group) -> bool:
    """Gloo has no all-gather or reduce-scatter of CUDA tensors (the ranks
    of one card): there they are all-reduces of the zero-padded shards
    and of the whole tensor."""
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _gathered(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards ``x`` concatenated along ``dim``."""
    import torch.distributed as dist
    x = x.contiguous()
    if not _all_reduce_only(x, group):
        return _done(_all_gather(x, dim, group))
    n, r = x.shape[dim], dist.get_rank(group)
    shape = list(x.shape)
    shape[dim] = n * dist.get_world_size(group)
    buf = x.new_zeros(shape)
    buf.narrow(dim, r * n, n).copy_(x)
    return _done(funcol.all_reduce(buf, "sum", group))


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (the group's size parts)."""
    import torch.distributed as dist
    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()


def _scattered(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of the group's ``g``."""
    g = g.contiguous()
    if not _all_reduce_only(g, group):
        return _done(_reduce_scatter(g, "sum", dim, group))
    return _own_slice(_done(funcol.all_reduce(g, "sum", group)), dim, group)


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


class _Gather(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward, over ``ctx.group``."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        with own_source():
            return _gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        with own_source():
            return _scattered(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter forward, all-gather backward, over ``ctx.group``."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        with own_source():
            return _scattered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        with own_source():
            return _gathered(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    """This rank's slice forward, all-gather backward, over ``ctx.group``."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        with own_source():
            return _gathered(g, ctx.dim, ctx.group), None, None


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


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max over ``group`` (``model``'s when None) of
    ``x`` (no gradient: a logsumexp's shift)."""
    with own_source():
        return _done(funcol.all_reduce(
            x.detach(), "max", _model_group() if group is None else group))


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum over ``group`` of ``x`` (no gradient)."""
    with own_source():
        return _done(funcol.all_reduce(x.detach(), "sum", group))


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every ``model`` rank's shard ``x`` concatenated along ``dim``; the
    gradient reduce-scattered back to the shards."""
    return _Gather.apply(x, dim, _model_group())


def model_grad_share(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient divided by the ``model`` axis size:
    for a term that every ``model`` rank computes whole but whose
    gradient reaches the parameters through a sum over ``model``
    (:func:`copy_to_model`, :func:`gather_from_model`), so that the sum
    counts it once."""
    m = model_size()
    return x if m == 1 else _ScaleGrad.apply(x, 1.0 / m)


# -- sequence parallelism: the residual stream (B, S/m, D) between blocks

def seq_parallel(seq_len: int) -> bool:
    """Whether a residual stream of ``seq_len`` positions is split on
    ``model`` between blocks: the rules put ``res_seq`` there (the
    ``seq_shard`` cells) and ``seq_len`` divides the axis, else the
    reference's ``resolve_axis`` opts out (decode's one position, an odd
    prompt)."""
    return model_size() > 1 and resolve_axis("res_seq", seq_len) == "model"


def enter_parallel(x: torch.Tensor, sp: bool) -> torch.Tensor:
    """An activation (B, S, ...) entering column-parallel work, whose
    gradient each rank only has its part of: :func:`copy_to_model`, or
    under sequence parallelism (``sp``) the ranks' seq slices all-gathered
    (a reduce-scatter on seq backward)."""
    return _Gather.apply(x, 1, _model_group()) if sp else copy_to_model(x)


def leave_parallel(y: torch.Tensor, sp: bool) -> torch.Tensor:
    """Row-parallel partial sums (B, S, ...) leaving:
    :func:`reduce_from_model`, or under sequence parallelism the rank's
    seq slice of their sum, a reduce-scatter on seq (an all-gather
    backward)."""
    return _Scatter.apply(y, 1, _model_group()) if sp \
        else reduce_from_model(y)


def whole_seq(x: torch.Tensor, sp: bool) -> torch.Tensor:
    """Under sequence parallelism the whole sequence from the ranks'
    slices, for work that every ``model`` rank does whole (its gradient,
    the same on every rank, counted once); ``x`` itself otherwise."""
    if not sp:
        return x
    return model_grad_share(_Gather.apply(x, 1, _model_group()))


def own_seq(y: torch.Tensor, sp: bool) -> torch.Tensor:
    """Under sequence parallelism this rank's seq slice of ``y`` (B, S,
    ...), which every ``model`` rank computed whole (its gradient
    all-gathered, so that the whole-work behind it sees the whole one);
    ``y`` itself otherwise."""
    return _Split.apply(y, 1, _model_group()) if sp else y


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch axes ('pod', 'data') of the active
    mesh: one all-reduce (sum, then divided by the axes' size) under any
    mesh, a batch axis of size 1 included, so traced steps have the same
    vertices at every scale; the identity without a mesh.  The backward
    passes the cotangent through unchanged: every batch rank's loss holds
    the same mean, and the step's data-parallel mean already divides the
    summed gradients by the axes' size."""
    if _CTX.mesh is None:
        return x
    batch = batch_group()
    if batch is None:
        return x
    return _BatchMean.apply(x, *batch)


def sharding_for(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh=None, rules: Optional[Dict[str, Rule]] = None
                 ) -> Tuple[Any, Tuple[Any, ...]]:
    """``(DeviceMesh, placements)`` of a value with these logical axes."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None or isinstance(mesh, Mapping):
        raise ValueError("sharding_for requires a DeviceMesh")
    return mesh, placements_for(spec_for(logical_axes, shape, mesh, rules),
                                mesh)

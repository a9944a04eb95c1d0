"""Cost walk over a traced FX graph: the port's roofline inputs.

The twin of the JAX package's ``core/hlo_walk.py``.  That module walks
the compiled HLO text with trip-count multipliers; this one walks the
ATen graph that :func:`repro_torch.core.psg.trace` records
(``Traced.graph_module``, the graph ``Cell.lower()`` returns).
``make_fx`` unrolls every Python loop, so each node runs once and no
multiplier is needed.  Everything is per rank: the graph is one rank's
program.

Per graph the walk counts:

  * ``dot_flops`` — 2 x |out| x contraction of every matrix product
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``, by
    :func:`repro_torch.core.costs.node_costs`), the ops the reference's
    lowering makes an HLO ``dot``; elementwise work is left out, as there;
  * ``mem_bytes`` — operand plus result bytes of every node that moves
    data (a broadcast operand counts its elements once, not its
    expanded size), with the reference's exceptions: a view or layout op (its
    result shares its operand's storage) moves nothing; a gathered read
    (``index``, ``index_select``, ``gather``, ``embedding``) reads and
    writes its result, not its source; an in-place or scatter update of
    a region (``index_put``, ``slice_scatter``, ``copy_``...) reads and
    writes the region, not the destination (the decode cache write);
  * ``coll_bytes`` / ``coll_counts`` by kind — each functional
    collective's **result** bytes, the convention of the reference's
    ``parse_collectives`` (an all-gather's result is m x its input, a
    reduce-scatter's 1/m).  The PSG's Comm vertices carry ``comm_bytes``,
    the **input** bytes (``psg._comm_bytes``); the two are kept apart.
    Each collective is also listed with its input bytes, its group size
    and whether its ranks lie inside one ``NODE_CARDS``-card NVLink node.

and a liveness walk in program order, the port's ``memory_analysis()``:
``argument_bytes`` (the rank's inputs, exact), ``output_bytes``
(``alias_bytes`` of them updated in place in an argument, as the decode
cache is), ``temp_bytes`` (the highest sum of live intermediates) and
``peak_bytes`` (arguments + temp).  A storage is freed after the later
of the last use of any of its views in the graph and the point where
the traced program dropped its last Python reference to it
(``graph_module.meta["dropped"]``, noted while tracing), as the caching
allocator frees it when the program runs eagerly.  It estimates that
allocator; it is not XLA's buffer assignment (no fusion, no reuse
beyond that, allocator rounding and library workspaces left out).

A graph with collectives must be walked while its process group (a fake
one, for a traced mesh) is still initialised: the group names resolve to
ranks then.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Dict, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.core import costs

# the reference's HLO names of the functional collectives
COLLECTIVE_KINDS = {"all_reduce": "all-reduce",
                    "all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}
DOT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm"})
# a read of the indexed rows only: 2 x result + the indices
GATHER_OPS = frozenset({"index", "index_select", "gather", "embedding"})
# an update of a region: 2 x the region (the values) + the indices
REGION_OPS = frozenset({"index_put", "index_put_", "slice_scatter",
                        "select_scatter", "copy_", "scatter_",
                        "index_copy_", "index_copy"})
# the values argument of a region update
_REGION_SRC = {"index_put": 2, "index_put_": 2, "slice_scatter": 1,
               "select_scatter": 1, "copy_": 1, "scatter_": 3,
               "index_copy_": 3, "index_copy": 3}
_FREE = frozenset({"_record_function_enter", "_record_function_enter_new",
                   "_record_function_exit", "empty", "empty_like",
                   "empty_strided", "arange", "wait_tensor"})
NODE_CARDS = 8              # cards a node joined by NVLink (HGX H100)


@dataclasses.dataclass
class Collective:
    """One functional collective of the graph."""
    kind: str                  # the reference's HLO name, e.g. all-gather
    result_bytes: float        # parse_collectives' convention
    input_bytes: float         # the PSG's comm_bytes
    group: List[int]           # global ranks of its group
    intra_node: bool           # all ranks inside one NVLink node


@dataclasses.dataclass
class FxCost:
    """The per-rank cost of one traced graph (the fields of the
    reference's ``HloCost``, plus the collectives and the memory walk)."""
    dot_flops: float
    mem_bytes: float
    coll_bytes: Dict[str, float]
    coll_counts: Dict[str, float]
    collectives: List[Collective] = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    alias_bytes: int = 0       # outputs that are argument storages

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes


def _vals(x) -> List[torch.Tensor]:
    return list(costs._tensors(x))


def _key(t: torch.Tensor):
    return StorageWeakRef(t.untyped_storage())


def _nbytes(t: torch.Tensor) -> int:
    return int(t.untyped_storage().nbytes())


def _size(ts) -> int:
    """Bytes a kernel reads or writes for these tensors: their elements,
    a broadcast dim (stride 0) counted once."""
    return sum(t.element_size() * math.prod(
        d for d, st in zip(t.shape, t.stride()) if st != 0) for t in ts)


def _arg_bytes(node: torch.fx.Node, skip: Tuple[int, ...] = ()) -> int:
    """Bytes of the node's tensor operands, but those at ``skip``."""
    args = [a for i, a in enumerate(node.args) if i not in skip]
    return _size(_vals(args + list(node.kwargs.values())))


def _collective(node: torch.fx.Node) -> Optional[Collective]:
    if getattr(node.target, "namespace", None) != "_c10d_functional":
        return None
    kind = COLLECTIVE_KINDS.get(costs.op_name(node))
    if kind is None:
        return None
    from repro_torch.core.psg import _group_ranks
    group = _group_ranks(node.args[-1])
    return Collective(kind, float(_size(_vals(node.meta.get("val")))),
                      float(_size(_vals(node.args[0]))), group,
                      len({r // NODE_CARDS for r in group}) == 1)


def _traffic(node: torch.fx.Node, name: str, outs, fresh: bool) -> float:
    """Bytes one node moves (see the module docstring)."""
    if name in _FREE or name.startswith("_record_function"):
        return 0.0
    if not fresh and not name.endswith("_"):
        return 0.0                         # a view: shares its storage
    if name in GATHER_OPS:
        idx = _arg_bytes(node, skip=(0,))
        return 2.0 * _size(outs) + idx
    if name in REGION_OPS:
        i = _REGION_SRC[name]
        src = node.args[i] if i < len(node.args) else None
        vals = _vals(src)
        others = _arg_bytes(node, skip=(0, i))
        return 2.0 * _size(vals) + others
    return float(_arg_bytes(node) + _size(outs))


def walk(graph_module: torch.fx.GraphModule) -> FxCost:
    """The per-rank cost and memory of one traced graph."""
    nodes = list(graph_module.graph.nodes)
    dot = mem = 0.0
    coll: Dict[str, float] = {}
    cnt: Dict[str, float] = {}
    colls: List[Collective] = []
    size: Dict[object, int] = {}          # storage -> bytes
    born: Dict[object, int] = {}          # storage -> producing node index
    last: Dict[object, int] = {}          # storage -> last use
    args: set = set()
    outs: set = set()
    node_keys: Dict[torch.fx.Node, List[object]] = {}
    for i, node in enumerate(nodes):
        if node.op == "output":
            for t in _vals(node.args):
                outs.add(_key(t))
            for a in node.all_input_nodes:
                for k in node_keys.get(a, ()):
                    last[k] = i
            continue
        vals = _vals(node.meta.get("val"))
        keys = [_key(t) for t in vals]
        node_keys[node] = keys
        fresh = False
        for k, t in zip(keys, vals):
            if k not in size:
                size[k] = _nbytes(t)
                born[k] = i
                fresh = True
            last[k] = max(last.get(k, i), i)
        for a in node.all_input_nodes:
            for k in node_keys.get(a, ()):
                last[k] = i
        if node.op == "placeholder":
            args.update(keys)
            continue
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        name = costs.op_name(node)
        c = _collective(node)
        if c is not None:
            colls.append(c)
            coll[c.kind] = coll.get(c.kind, 0.0) + c.result_bytes
            cnt[c.kind] = cnt.get(c.kind, 0.0) + 1.0
        if name in DOT_OPS:
            dot += costs.node_costs(node)[0]
        mem += _traffic(node, name, vals, fresh)

    # liveness: a storage lives from its producer to its last use, or to
    # where the program dropped its last reference to it if that is later
    # (a Python variable outliving the value's last use); arguments are
    # not temporaries, outputs live to the end
    index = {n: i for i, n in enumerate(nodes)}
    for k, n in graph_module.meta.get("dropped", {}).items():
        if k in last and n in index:
            last[k] = max(last[k], index[n])
    end = len(nodes)
    delta = [0] * (end + 1)
    for k, n in size.items():
        if k in args:
            continue
        delta[born[k]] += n
        stop = end if k in outs else last[k] + 1
        delta[stop] -= n
    live = temp = 0
    for d in delta:
        live += d
        temp = max(temp, live)
    return FxCost(dot_flops=dot, mem_bytes=mem, coll_bytes=coll,
                  coll_counts=cnt, collectives=colls,
                  argument_bytes=sum(size[k] for k in args),
                  output_bytes=sum(size[k] for k in outs),
                  temp_bytes=temp,
                  alias_bytes=sum(size[k] for k in outs if k in args))

"""Static PSG construction from a torch program (the paper's compile-time
analysis).

The torch counterpart of a jaxpr is one ATen-level graph: ``make_fx``
traces ``fn(*args)`` over fake tensors into the forward, the
checkpoints' recompute, the backward and the optimizer, in execution
order.  A Python loop leaves no mark in that graph, so the program marks
its loops with :func:`scan`, the twin of ``jax.lax.scan``: a
``record_function`` scope around the loop and one inside each iteration
(inside the checkpointed body under ``remat``, so a recompute re-emits
it, and a profile of an eager run shows the loops too).

While tracing, a torch-function mode gives every call the loop frames
it runs in and its ``file:line`` (the first frame outside torch), and
hands both to the ATen nodes the call makes through the node metadata
that ``torch.fx.traceback.preserve_node_meta`` carries.  It also tags
each autograd node the call creates; a pre-hook on that node hands the
same frames, turned into backward frames, to the ATen nodes of its
backward, so the backward of a marked loop (and the recompute it
triggers) is a loop of its own, as the transposed ``scan`` is in a jaxpr.

The program marks a data-dependent branch with :func:`cond`, the twin
of ``jax.lax.cond``: the arm that runs gets a frame of its own (one
trip), in the forward, in its backward and in a checkpoint's recompute.

The builder then folds each run of one loop's nodes into a Loop vertex
with ``meta["trip_count"]`` and its body from the run's lowest-numbered
iteration (the first in the forward, the last to run in a backward), and
each run of one branch's nodes into a Branch vertex over the arm's nodes;
every other ATen node is a Comp vertex with the counters of
:mod:`repro_torch.core.costs`.  A loop's counters are the sum over all
its iterations (``trip_count`` times the body when the iterations are
alike, as ``_rollup`` does in the JAX package).  Data edges are def-use
edges between vertices at one nesting level, with program order where a
vertex reads nothing made at its level; control edges join a loop to
its children.  A functional collective (``torch.distributed.
_functional_collectives``: the data-parallel step's gradient all-reduce)
is a Comm vertex, as a collective primitive of a jaxpr is in the JAX
package: ``comm_kind`` in the reference's names, ``comm_bytes`` its
input's bytes, ``meta["replica_groups"]`` its group's ranks; the
``wait_tensor`` that completes it is folded into it.

One trace at a time: :func:`trace` is not reentrant.
"""
from __future__ import annotations

import contextlib
import dataclasses
import operator
import os
import sys
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.fx.traceback as fx_traceback
from torch.overrides import TorchFunctionMode

from repro_torch.core import costs, spans
from repro_torch.core.graph import (BRANCH, COMM, COMP, LOOP, PSG, ROOT,
                                    Vertex)

LOOP_SCOPE = "scalana.loop:"
ITER_SCOPE = "scalana.iter:"
BRANCH_SCOPE = "scalana.branch:"
_KEY = "scalana:"
# frames that are not the program's: as the code objects name them
_SKIP_FILES = (os.path.dirname(torch.__file__) + os.sep, __file__,
               contextlib.__file__)

# (loop or branch instance, backward?, iteration): one enclosing loop or
# branch of a node (a branch's iteration is always 0)
Frame = Tuple[int, bool, Optional[int]]


def _caller() -> str:
    """``file:line`` of the innermost frame outside torch and this module."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename.startswith(_SKIP_FILES):
        f = f.f_back
    return ("" if f is None else
            f"{os.path.normpath(f.f_code.co_filename)}:{f.f_lineno}")


class _Trace:
    """The loop frames, keys and autograd hooks of one trace."""

    def __init__(self) -> None:
        # instance -> (name, src, kind): LOOP or BRANCH
        self.loops: List[Tuple[str, str, str]] = []
        self.stack: List[List[Any]] = []            # [instance, iteration]
        self.keys: Dict[Tuple[str, Tuple[Frame, ...]], int] = {}
        self.table: List[Tuple[str, Tuple[Frame, ...]]] = []
        self.bwd: Optional[Tuple[Frame, ...]] = None   # running backward
        self.in_task = False
        # the program's own references: storage -> live tensor objects,
        # and the graph's last node when the last of them died
        self.graph: Optional[torch.fx.Graph] = None
        self.held: Dict[Any, int] = {}
        self.dropped: Dict[Any, torch.fx.Node] = {}
        self._held_ids: set = set()

    def forward_path(self) -> Tuple[Frame, ...]:
        return tuple((inst, False, it) for inst, it in self.stack)

    def key(self, src: str, path: Tuple[Frame, ...]) -> str:
        k = self.keys.get((src, path))
        if k is None:
            k = self.keys[(src, path)] = len(self.table)
            self.table.append((src, path))
        return f"{_KEY}{k}"

    def tag(self, out: Any, src: str) -> None:
        """Tag the autograd nodes ``out`` brings in with ``src`` and the
        forward frames; their pre-hooks start their backward's frames."""
        path = self.forward_path()
        todo = [t.grad_fn for t in _flatten(out)[0] if t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if (node is None or "scalana" in node.metadata
                    or hasattr(node, "variable")):    # AccumulateGrad
                continue
            node.metadata["scalana"] = (src, path)
            node.register_prehook(self._prehook(src, path))
            todo.extend(fn for fn, _ in node.next_functions)

    def _prehook(self, src: str, path: Tuple[Frame, ...]) -> Callable:
        def pre(grad_outputs):
            if not self.in_task:
                self.in_task = True
                torch.autograd.Variable._execution_engine.queue_callback(
                    self._end_backward)
            # frames still open (a loop around the grad call) stay forward
            live = self.forward_path()
            k = 0
            while k < min(len(path), len(live)) and path[k] == live[k]:
                k += 1
            self.bwd = path[:k] + tuple((inst, True, it)
                                        for inst, _, it in path[k:])
            fx_traceback.set_stack_trace([self.key(src, self.bwd)])
        return pre

    def _end_backward(self) -> None:
        self.bwd, self.in_task = None, False
        fx_traceback.set_stack_trace([])

    def hold(self, tensors: Sequence[torch.Tensor]) -> None:
        """Watch the tensor objects the program holds: when the last one
        on a storage dies (as it would free the storage running eagerly),
        note the graph's last node (``core/fx_walk.py`` reads it)."""
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in tensors:
            if self.graph is None or id(t) in self._held_ids:
                continue
            try:
                key = StorageWeakRef(t.untyped_storage())
            except (NotImplementedError, RuntimeError):
                continue                      # no storage (a wrapper)
            self._held_ids.add(id(t))
            self.held[key] = self.held.get(key, 0) + 1
            weakref.finalize(t, self._release, id(t), key)

    def _release(self, oid: int, key: Any) -> None:
        self._held_ids.discard(oid)
        self.held[key] -= 1
        if not self.held[key] and self.graph is not None:
            self.dropped[key] = self.graph._root.prev


_TRACE: Optional[_Trace] = None


class _Tagger(TorchFunctionMode):
    """Hands each call's source and frames to the ATen nodes it makes."""

    def __init__(self, trace: _Trace):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        tr = self.trace
        src = _caller()
        prev = fx_traceback.get_current_meta().get("stack_trace")
        fx_traceback.set_stack_trace(
            [tr.key(src, tr.bwd if tr.bwd is not None
                    else tr.forward_path())])
        try:
            out = func(*args, **(kwargs or {}))
        finally:
            fx_traceback.set_stack_trace([prev] if prev else [])
        if tr.bwd is None:             # a recompute's graph never runs
            tr.tag(out, src)
        tr.hold(_flatten((args, kwargs, out))[0])
        return out


# ---------------------------------------------------------------------------
# Loop scopes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _loop(name: str, src: str):
    tr = _TRACE if _TRACE is not None and _TRACE.bwd is None else None
    with torch.profiler.record_function(
            f"{LOOP_SCOPE}{name}@{os.path.basename(src)}"):
        if tr is not None:
            tr.stack.append([len(tr.loops), None])
            tr.loops.append((name, src, LOOP))
        try:
            yield
        finally:
            if tr is not None:
                tr.stack.pop()


def _iterate(body: Callable, name: str, i: int, carry: Any, x: Any):
    tr = _TRACE
    frame = (tr.stack[-1] if tr is not None and tr.bwd is None and tr.stack
             else None)
    with torch.profiler.record_function(f"{ITER_SCOPE}{name}:{i}"):
        if frame is not None:
            frame[1] = i
        try:
            return body(carry, x)
        finally:
            if frame is not None:
                frame[1] = None


def scan(body: Callable[[Any, Any], Tuple[Any, Any]], carry: Any,
         xs: Sequence[Any], *, name: str, remat: bool = False
         ) -> Tuple[Any, List[Any]]:
    """``carry, y = body(carry, x)`` for each ``x`` of ``xs``, in order:
    the twin of ``jax.lax.scan``, with ``jax.checkpoint`` on the body when
    ``remat`` (``torch.utils.checkpoint``, non-reentrant).  Returns the
    last carry and the list of ``y``.  The loop is named ``name`` in the
    PSG and in profiles."""
    src = _caller()
    ys = []
    with _loop(name, src):
        for i, x in enumerate(xs):
            if remat:
                carry, y = torch.utils.checkpoint.checkpoint(
                    _iterate, body, name, i, carry, x,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                carry, y = _iterate(body, name, i, carry, x)
            ys.append(y)
    return carry, ys


@contextlib.contextmanager
def own_source():
    """For code that autograd runs (a custom ``Function``'s backward, a
    checkpoint's recompute), which the trace's torch-function mode does
    not see: the nodes made inside get the caller's ``file:line`` with
    the running backward's frames, not those of the autograd node that
    triggered it."""
    tr = _TRACE
    if tr is None or tr.bwd is None:
        yield
        return
    prev = fx_traceback.get_current_meta().get("stack_trace")
    fx_traceback.set_stack_trace([tr.key(_caller(), tr.bwd)])
    try:
        yield
    finally:
        fx_traceback.set_stack_trace([prev] if prev else [])


def cond(pred: bool, true_fn: Callable[[Any], Any],
         false_fn: Callable[[Any], Any], operand: Any, *, name: str) -> Any:
    """``true_fn(operand)`` if ``pred`` else ``false_fn(operand)``: the
    twin of ``jax.lax.cond`` for a ``pred`` that is a Python bool.  The
    arm that runs is a Branch vertex named ``cond:<name>`` in the PSG,
    and a ``record_function`` scope in profiles.  In a checkpoint's
    recompute the arm's nodes get the frame again, under the backward's
    enclosing loop frames."""
    src = _caller()
    fn = true_fn if pred else false_fn
    tr = _TRACE
    with torch.profiler.record_function(
            f"{BRANCH_SCOPE}{name}@{os.path.basename(src)}"):
        if tr is None:
            return fn(operand)
        if tr.bwd is None:
            tr.stack.append([len(tr.loops), 0])
            tr.loops.append((name, src, BRANCH))
            try:
                return fn(operand)
            finally:
                tr.stack.pop()
        # a recompute: the arm under the frames of the loop being
        # recomputed (a recompute triggered inside the arm's own backward
        # carries the arm's frame already: drop it first)
        prev = tr.bwd
        outer = prev
        while outer and tr.loops[outer[-1][0]][2] == BRANCH:
            outer = outer[:-1]
        tr.bwd = outer + ((len(tr.loops), True, 0),)
        tr.loops.append((name, src, BRANCH))
        fx_traceback.set_stack_trace([tr.key(src, tr.bwd)])
        try:
            return fn(operand)
        finally:
            tr.bwd = prev
            fx_traceback.set_stack_trace([tr.key(src, prev)])


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses, and
    ``rebuild(tensors)`` giving the tree back (other leaves kept as
    they are)."""
    out: List[torch.Tensor] = []

    def spec(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
            return lambda it: next(it)
        if isinstance(t, dict):
            parts = [(k, spec(v)) for k, v in t.items()]
            return lambda it: {k: p(it) for k, p in parts}
        if isinstance(t, (list, tuple)):
            parts = [spec(v) for v in t]
            if hasattr(t, "_fields"):                   # NamedTuple
                return lambda it: type(t)(*(p(it) for p in parts))
            return lambda it: type(t)(p(it) for p in parts)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            parts = [(f.name, spec(getattr(t, f.name)))
                     for f in dataclasses.fields(t)]
            return lambda it: type(t)(**{k: p(it) for k, p in parts})
        return lambda it: t

    build = spec(tree)
    return out, lambda tensors: build(iter(tensors))


@dataclasses.dataclass
class Traced:
    """One traced program: its graph, its PSG, and each ATen node's
    top-level PSG vertex."""
    graph_module: torch.fx.GraphModule
    psg: PSG
    top_vertex: Dict[torch.fx.Node, int]
    rebuild_out: Callable[[Sequence[torch.Tensor]], Any]

    def flat_args(self, *args) -> List[torch.Tensor]:
        return _flatten(args)[0]


def trace(fn: Callable, *args, max_depth: int = 64) -> Traced:
    """Trace ``fn(*args)`` over fake tensors on the arguments' devices and
    build its PSG.  ``fn`` must be functional (no in-place writes to its
    inputs) and take no data-dependent Python branch."""
    from torch.fx.experimental.proxy_tensor import make_fx
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("a PSG trace is already in progress")
    leaves, rebuild = _flatten(args)
    rebuild_out: List[Callable] = []
    tr = _Trace()

    def flat(*tensors):
        from torch.fx.experimental.proxy_tensor import get_proxy_mode
        mode = get_proxy_mode()
        tr.graph = None if mode is None else mode.tracer.graph
        with _Tagger(tr):
            out = fn(*rebuild(tensors))
        out_leaves, rb = _flatten(out)
        rebuild_out.append(rb)
        return out_leaves

    _TRACE = tr
    try:
        # the span around make_fx, never inside it: a record_function in
        # the traced code is a marker node of the graph
        with spans.span("psg.make_fx"), fx_traceback.preserve_node_meta():
            gm = make_fx(flat, tracing_mode="fake")(*leaves)
    finally:
        _TRACE = None
        tr.graph = None
    with spans.span("psg.build"):
        # where the program dropped its last reference to each storage it
        # held (the cost walk's liveness): nodes of the traced graph
        gm.meta["dropped"] = {k: n for k, n in tr.dropped.items()
                              if n.graph is gm.graph}
        b = _Builder(tr, max_depth)
        b.build(gm)
    return Traced(gm, b.psg, b.top, rebuild_out[0])


def build_psg(fn: Callable, *args, max_depth: int = 64) -> PSG:
    """Static analysis: trace ``fn(*args)`` -> PSG."""
    return trace(fn, *args, max_depth=max_depth).psg


def top_level_order(psg: PSG) -> List[int]:
    """Program-order vids directly under the root (children index is
    maintained in creation = program order)."""
    return psg.children(psg.root)


# ---------------------------------------------------------------------------
# Graph -> PSG
# ---------------------------------------------------------------------------

_MARKERS = ("_record_function_enter", "_record_function_exit")
Item = Tuple[torch.fx.Node, str, Tuple[Frame, ...]]

# functional collective -> (the reference's comm_kind, group-name argument)
COLLECTIVES = {"all_reduce": ("all_reduce", 2),
               "all_gather_into_tensor": ("all_gather", 2),
               "reduce_scatter_tensor": ("reduce_scatter", 3),
               "all_to_all_single": ("all_to_all", 3)}
_C10D = "_c10d_functional"


def _collective(node: torch.fx.Node) -> Optional[Tuple[str, int]]:
    """(comm_kind, group argument) of a functional collective node."""
    if getattr(node.target, "namespace", None) != _C10D:
        return None
    return COLLECTIVES.get(costs.op_name(node))


def _waited(node: torch.fx.Node) -> Optional[torch.fx.Node]:
    """The collective a ``wait_tensor`` node completes, or None."""
    if (getattr(node.target, "namespace", None) == _C10D
            and costs.op_name(node) == "wait_tensor"):
        return _producer(node.args[0])
    return None


def _group_ranks(name: str) -> List[int]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return [int(r) for r in
            dist.get_process_group_ranks(_resolve_process_group(name))]


def _comm_bytes(node: torch.fx.Node) -> float:
    """The collective's input bytes (``_comm_bytes`` of the JAX package)."""
    t = node.args[0].meta["val"]
    return float(t.numel() * t.element_size())


def _is_vertex(node: torch.fx.Node) -> bool:
    """An ATen op of the program (not I/O, a tuple pick or a profiler
    scope marker)."""
    if node.op != "call_function" or node.target is operator.getitem:
        return False
    return not costs.op_name(node).startswith(_MARKERS)


def _producer(a: torch.fx.Node) -> torch.fx.Node:
    while a.op == "call_function" and a.target is operator.getitem:
        a = a.args[0]
    return a


class _Builder:
    def __init__(self, tr: _Trace, max_depth: int):
        self.tr = tr
        self.max_depth = max_depth
        self.psg = PSG()
        root = self.psg.new_vertex(ROOT, "root")
        self.psg.root = root.vid
        self.top: Dict[torch.fx.Node, int] = {}
        self._costs: Dict[torch.fx.Node, Tuple[float, float]] = {}

    def build(self, gm: torch.fx.GraphModule) -> None:
        items: List[Item] = []
        src, path = "", ()
        for node in gm.graph.nodes:
            st = node.meta.get("stack_trace") or ""
            if st.startswith(_KEY):
                src, path = self.tr.table[int(st[len(_KEY):])]
            if _is_vertex(node):           # no key: the last one holds
                items.append((node, src, path))
        self.walk(items, self.psg.root, 0)

    def cost(self, node: torch.fx.Node) -> Tuple[float, float]:
        c = self._costs.get(node)
        if c is None:
            c = self._costs[node] = costs.node_costs(node)
        return c

    def walk(self, items: List[Item], parent: int, depth: int) -> None:
        """One nesting level: each item whose path is empty here is a Comp
        vertex, each run of one loop's items a Loop vertex."""
        var_def: Dict[torch.fx.Node, int] = {}
        prev: Optional[int] = None
        i = 0
        while i < len(items):
            node, src, path = items[i]
            j = i + 1
            coll = _waited(node) if not path else None
            if coll in var_def:                # folded into its Comm vertex
                var_def[node] = var_def[coll]
                if depth == 0:
                    self.top[node] = var_def[coll]
                i = j
                continue
            if not path:
                v = self._vertex(node, src, parent, depth)
            else:
                while j < len(items) and items[j][2][:1] and \
                        items[j][2][0][:2] == path[0][:2]:
                    j += 1
                v = self._loop(items[i:j], parent, depth)
            run = [n for n, _, _ in items[i:j]]
            producers = {var_def[p] for n in run
                         for p in map(_producer, n.all_input_nodes)
                         if p in var_def}
            producers.discard(v.vid)
            for p in producers:
                self.psg.add_edge(p, v.vid, "data")
            if not producers and prev is not None:
                # fall back to program order so the chain stays connected
                self.psg.add_edge(prev, v.vid, "data")
            for n in run:
                var_def[n] = v.vid
                if depth == 0:
                    self.top[n] = v.vid
            self.psg.add_edge(parent, v.vid, "control")
            prev = v.vid
            i = j

    def _vertex(self, node: torch.fx.Node, src: str, parent: int,
                depth: int) -> Vertex:
        comm = _collective(node)
        if comm is None:
            v = self.psg.new_vertex(COMP, costs.op_name(node), source=src,
                                    parent=parent, depth=depth)
            v.prims = [v.name]
            v.flops, v.bytes = self.cost(node)
            return v
        kind, group_arg = comm
        v = self.psg.new_vertex(COMM, costs.op_name(node), source=src,
                                parent=parent, depth=depth)
        v.comm_kind = kind
        v.comm_bytes = _comm_bytes(node)
        v.meta["replica_groups"] = [_group_ranks(node.args[group_arg])]
        return v

    def _loop(self, run: List[Item], parent: int, depth: int) -> Vertex:
        inst, backward, _ = run[0][2][0]
        name, src, kind = self.tr.loops[inst]
        its = [p[0][2] for _, _, p in run if p[0][2] is not None]
        grad = ".grad" if backward else ""
        if kind == BRANCH:
            v = self.psg.new_vertex(BRANCH, f"cond:{name}{grad}", source=src,
                                    parent=parent, depth=depth)
        else:
            v = self.psg.new_vertex(
                LOOP, f"scan:{name}{grad}", source=src, parent=parent,
                depth=depth, meta={"trip_count": len(set(its)) or 1})
        if depth < self.max_depth and its:
            body = min(its)
            self.walk([(n, s, p[1:]) for n, s, p in run if p[0][2] == body],
                      v.vid, depth + 1)
        cs = [self.cost(n) for n, _, _ in run]
        v.flops = float(sum(c[0] for c in cs))
        v.bytes = float(sum(c[1] for c in cs))
        v.comm_bytes = float(sum(_comm_bytes(n) for n, _, _ in run
                                 if _collective(n) is not None))
        return v

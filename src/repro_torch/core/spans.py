"""Named host spans and the Python collector's pauses, on the clock of a
``torch.profiler`` trace.

``span(name)`` opens ``torch.profiler.record_function(name)``, so under a
``torch.profiler`` the span is a host range of the Kineto trace, on the
clock of the device's kernels, and it adds its length on the host clock
to a running total for ``name``: count, seconds and the longest.  With no
profiler recording only the totals move.

A ``gc.callbacks`` hook, installed once a process when this module is
imported, totals each cyclic collection the same way under
``python.gc:gen<N>``.  While a profiler records it also opens a range of
that name around the collection, except under a ``torch`` dispatch mode
(a ``make_fx`` trace), where the range would be a node of the graph.

``collect()`` gathers what closes while it is open: the Trainer keeps one
a ``Trainer.train`` call (``Trainer.span_log``), the profiler one over
its construction (``GraphProfiler.trace_spans``).  ``record`` keeps the
process's last of them for a reader that holds neither object
(:func:`recent`).

No span may open inside a function that ``make_fx`` traces: its
``record_function`` would become a marker node of the graph.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

# name -> {"count", "seconds", "longest"}
Totals = Dict[str, Dict[str, float]]

TOTALS: Totals = {}               # the process's, since the import
_SINKS: List[Totals] = [TOTALS]
_RECENT: collections.deque = collections.deque(maxlen=64)

GC_NAMES = tuple(f"python.gc:gen{g}" for g in range(3))


def _add(name: str, ns: int) -> None:
    s = ns * 1e-9
    for t in _SINKS:
        st = t.get(name)
        if st is None:
            t[name] = {"count": 1, "seconds": s, "longest": s}
        else:
            st["count"] += 1
            st["seconds"] += s
            if s > st["longest"]:
                st["longest"] = s


class span:
    """A named host span: a ``record_function`` range and a running total
    under ``total`` (``name`` by default).  A context manager, or
    ``open()`` / ``close()`` where the span does not follow a block;
    ``seconds`` is its length once closed."""

    __slots__ = ("name", "total", "seconds", "_rf", "_t0")

    def __init__(self, name: str, total: Optional[str] = None):
        self.name = name
        self.total = name if total is None else total
        self.seconds = 0.0

    def open(self) -> "span":
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def close(self) -> float:
        ns = time.perf_counter_ns() - self._t0
        self._rf.__exit__(None, None, None)
        self.seconds = ns * 1e-9
        _add(self.total, ns)
        return self.seconds

    __enter__ = open

    def __exit__(self, *exc) -> None:
        self.close()


@contextlib.contextmanager
def collect() -> Iterator[Totals]:
    """The totals of every span and collection that closes while open."""
    t: Totals = {}
    _SINKS.append(t)
    try:
        yield t
    finally:
        for i in range(len(_SINKS) - 1, 0, -1):
            if _SINKS[i] is t:
                del _SINKS[i]
                break


def record(scope: str, totals: Totals) -> Totals:
    """Keep ``totals`` among the process's recent ones under ``scope``."""
    _RECENT.append((scope, totals))
    return totals


def recent() -> List[Tuple[str, Totals]]:
    """(scope, totals) of the process's last recorded scopes, oldest
    first: ``"trainer.train"`` a call, ``"profiler.init"`` a profiler's
    construction."""
    return list(_RECENT)


_gc_open: List = [None, None]     # the collection's start, its range


def _on_gc(phase: str, info: Dict) -> None:
    if phase == "start":
        rf = None
        if (torch._C._autograd._profiler_enabled()
                and not torch._C._len_torch_dispatch_stack()):
            rf = torch.ops.profiler._record_function_enter_new(
                GC_NAMES[info["generation"]], None)
        _gc_open[1] = rf
        _gc_open[0] = time.perf_counter_ns()
        return
    t0, rf = _gc_open
    if t0 is None:
        return
    ns = time.perf_counter_ns() - t0
    _gc_open[0] = _gc_open[1] = None
    if rf is not None:
        torch.ops.profiler._record_function_exit._RecordFunction(rf)
    _add(GC_NAMES[info["generation"]], ns)


if not any(getattr(cb, "__qualname__", None) == "_on_gc"
           and getattr(cb, "__module__", None) == __name__
           for cb in gc.callbacks):
    gc.callbacks.append(_on_gc)

"""The host cost of :mod:`repro_torch.core.spans` with no profiler
recording, on the machine it runs on.

Prints one JSON line: microseconds a ``span`` (open and close), a bare
``record_function`` beside it, a call of the collector hook (its start
and stop phases together, as one collection runs them), and a gen-0
collection with the hook and without it; then a span and a hook call
while a ``torch.profiler`` records (``*_profiled``: the hook then opens
its range).  Medians of ``--repeats`` rounds of ``--n`` calls each (a
tenth of that for collections and under the profiler).  Run from the repository root:

    python3 tools_torch/span_cost.py
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402
from torch.autograd.profiler import record_function  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import spans  # noqa: E402


def _us(fn, n: int, repeats: int) -> float:
    rounds = []
    for _ in range(repeats):
        t = time.perf_counter_ns()
        fn(n)
        rounds.append((time.perf_counter_ns() - t) / n / 1e3)
    return statistics.median(rounds)


def _spans(n: int) -> None:
    for _ in range(n):
        with spans.span("span_cost"):
            pass


def _record_functions(n: int) -> None:
    for _ in range(n):
        with record_function("span_cost"):
            pass


def _hook(n: int) -> None:
    info = {"generation": 0, "collected": 0, "uncollectable": 0}
    for _ in range(n):
        spans._on_gc("start", info)
        spans._on_gc("stop", info)


def _gen0(n: int) -> None:
    for _ in range(n):
        gc.collect(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    n, r = args.n, args.repeats
    out = {"span_us": _us(_spans, n, r),
           "record_function_us": _us(_record_functions, n, r),
           "gc_hook_us": _us(_hook, n, r),
           "gen0_collect_us": _us(_gen0, n // 10, r)}
    gc.callbacks.remove(spans._on_gc)
    try:
        out["gen0_collect_unhooked_us"] = _us(_gen0, n // 10, r)
    finally:
        gc.callbacks.append(spans._on_gc)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["span_us_profiled"] = _us(_spans, n // 10, r)
        out["gc_hook_us_profiled"] = _us(_hook, n // 10, r)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

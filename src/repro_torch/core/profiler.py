"""Graph-guided sampling profiler (paper §III-B).

Sampling a running program's stack cannot attribute a card's time to
PSG vertices (its kernels run asynchronously), so the profiler samples
in *step space*, as the JAX package's does: every K-th step runs the
traced ATen graph through a ``torch.fx.Interpreter`` that fences each
top-level PSG vertex (``torch.cuda.synchronize()`` on a card; CPU ops
are synchronous) and records its time; all other steps run ``fn``
eagerly.  Expected overhead ≈ (instrumented_step/eager_step − 1)/K,
tunable like the paper's sampling frequency.

A vertex's time in a sampled step is the time of all its ATen nodes in
that step (a contracted Comp vertex covers a run of nodes, a Loop vertex
every iteration), one sample per sampled step.  Per-vertex performance
vectors combine this measured channel with the static counters
(flops/bytes from :mod:`repro_torch.core.costs`), the PAPI analogue.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import psg as psg_lib
from repro_torch.core.contraction import contract
from repro_torch.core.graph import PerfVector


def _fence(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class _TimedRun(torch.fx.Interpreter):
    """Runs the traced graph, timing each stretch of nodes that belongs to
    one top-level vertex; the values die after their last use."""

    def __init__(self, gm: torch.fx.GraphModule,
                 segment: Dict[torch.fx.Node, int],
                 device: Optional[torch.device]):
        super().__init__(gm)
        self.segment = segment
        self.device = device
        self.times: Dict[int, float] = {}
        self._open: Optional[int] = None
        self._t0 = 0.0

    def _close(self) -> None:
        _fence(self.device)
        now = time.perf_counter()
        if self._open is not None:
            self.times[self._open] = (self.times.get(self._open, 0.0)
                                      + now - self._t0)
        self._t0 = now

    def run_node(self, n: torch.fx.Node) -> Any:
        seg = self.segment.get(n)
        if seg is not None and seg != self._open:
            self._close()
            self._open = seg
        return super().run_node(n)

    def timed(self, *args) -> Any:
        self._close()                       # nothing earlier counts
        out = self.run(*args)
        self._close()
        return out


class GraphProfiler:
    """Profiles ``fn`` at PSG-vertex granularity with step-space sampling.

    Storage accounting mirrors the paper: per-vertex perf vectors (KBs)
    instead of per-event traces (GBs).
    """

    def __init__(self, fn: Callable, example_args: Sequence[Any], *,
                 sample_every: int = 16, max_loop_depth: int = 10):
        self.fn = fn
        self.sample_every = max(int(sample_every), 1)
        t0 = time.perf_counter()
        self.traced = psg_lib.trace(fn, *example_args)
        self.trace_s = time.perf_counter() - t0
        self.psg_full = self.traced.psg
        self.psg, self.mapping = contract(self.psg_full, max_loop_depth)
        # ATen node -> contracted top-level vertex
        self._segment = {n: self.mapping.get(vid, self.psg.root)
                         for n, vid in self.traced.top_vertex.items()}
        self._vertex_times: Dict[int, List[float]] = {}
        self.step_times: List[float] = []
        self.sampled_steps = 0
        self.total_steps = 0

    @staticmethod
    def _device(flat: Sequence[torch.Tensor]) -> Optional[torch.device]:
        return next((t.device for t in flat if t.device.type == "cuda"),
                    None)

    # ------------------------------------------------------------------
    def step(self, *args) -> Any:
        """Run one step; every K-th step is the instrumented sampled run."""
        self.total_steps += 1
        if self.total_steps % self.sample_every == 0:
            return self._sampled_step(*args)
        device = self._device(self.traced.flat_args(*args))
        _fence(device)
        t0 = time.perf_counter()
        out = self.fn(*args)
        _fence(device)
        self.step_times.append(time.perf_counter() - t0)
        return out

    def _sampled_step(self, *args) -> Any:
        self.sampled_steps += 1
        flat = self.traced.flat_args(*args)
        run = _TimedRun(self.traced.graph_module, self._segment,
                        self._device(flat))
        t0 = time.perf_counter()
        outs = run.timed(*flat)
        self.step_times.append(time.perf_counter() - t0)
        for vid, dt in run.times.items():
            self._vertex_times.setdefault(vid, []).append(dt)
        return self.traced.rebuild_out(outs)

    # ------------------------------------------------------------------
    def perf_vectors(self) -> Dict[int, PerfVector]:
        """Per-vertex perf vectors: measured time + static counters."""
        out: Dict[int, PerfVector] = {}
        for v in self.psg.vertices:
            times = self._vertex_times.get(v.vid, [])
            counters = {"flops": v.flops, "bytes": v.bytes,
                        "comm_bytes": v.comm_bytes}
            if times:
                t = float(np.mean(times))
                counters["flops_per_sec"] = v.flops / t if t > 0 else 0.0
                out[v.vid] = PerfVector(time=t,
                                        time_var=float(np.var(times)),
                                        samples=len(times),
                                        counters=counters)
            elif v.flops or v.comm_bytes:
                out[v.vid] = PerfVector(time=0.0, samples=0,
                                        counters=counters)
        return out

    def perf_shard(self, proc_start: int = 0, n_procs: int = 1):
        """This host's measured profile as a proc-range shard.

        Returns a :class:`~repro_torch.core.shard.PerfShard` covering
        global processes ``[proc_start, proc_start + n_procs)``, each local
        row filled with this profiler's per-vertex vectors (an SPMD host
        runs identical top-level structure on its local processes).  Hosts
        profile independently and the controller merges blocks late:
        ``PerfStore.from_shards(shards)`` or streamed
        ``build_ppg(psg, P, shards)``.
        """
        from repro_torch.core.shard import PerfShard
        shard = PerfShard(proc_start, n_procs, len(self.psg.vertices))
        procs = np.arange(int(n_procs))
        for vid, vec in self.perf_vectors().items():
            shard.set_entries(procs, vid, vec.time, time_var=vec.time_var,
                              samples=vec.samples, counters=vec.counters)
        return shard

    def base_times(self, default: float = 0.0) -> Callable:
        """Vectorized ``base_times`` seeded from the measured profile.

        Returns a callable with the replay engine's vectorized contract
        (``fn(procs_array, vid) -> seconds``; see
        :func:`repro_torch.core.inject.seeded_base_times`), so case
        studies replay real measured models without O(P·V) Python
        callbacks.  Unprofiled vertices replay at ``default`` seconds.
        """
        from repro_torch.core.inject import seeded_base_times
        table = np.full(len(self.psg.vertices), float(default))
        for vid, vec in self.perf_vectors().items():
            table[vid] = vec.time
        return seeded_base_times(table)

    def storage_bytes(self) -> int:
        """Bytes ScalAna retains: contracted PSG + per-vertex vectors."""
        vec_bytes = sum(8 * (3 + len(v.counters))
                        for v in self.perf_vectors().values())
        return self.psg.nbytes() + vec_bytes

    def full_trace_bytes(self) -> int:
        """What a full per-event tracer would have written for the same run:
        one 64-byte event per (node execution, step) incl. loop iterations."""
        events_per_step = 0
        for v in self.psg_full.vertices:
            trips = 1
            p = v.parent
            while p >= 0:
                trips *= int(self.psg_full.vertices[p].meta.get(
                    "trip_count", 1) or 1)
                p = self.psg_full.vertices[p].parent
            events_per_step += trips
        return events_per_step * 64 * self.total_steps

    def overhead_estimate(self) -> Dict[str, float]:
        if not self.step_times:
            return {}
        fast = [t for i, t in enumerate(self.step_times, start=1)
                if i % self.sample_every != 0]
        slow = [t for i, t in enumerate(self.step_times, start=1)
                if i % self.sample_every == 0]
        if not fast:
            return {}
        base = float(np.median(fast))
        extra = sum(max(t - base, 0.0) for t in slow)
        total = sum(self.step_times)
        return {
            "base_step_s": base,
            "sampled_step_s": float(np.median(slow)) if slow else 0.0,
            "overhead_frac": extra / max(total - extra, 1e-12),
        }

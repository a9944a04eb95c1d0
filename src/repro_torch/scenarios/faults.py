"""Declarative fault injection over recorded step traces.

Each fault is a frozen, parameter-only dataclass; :meth:`Fault.plan`
resolves it against one (trace, instantiated PSG, scale, seed) into a
:class:`FaultPlan` — the concrete replay-engine inputs (vectorized base
times, ``{(proc, vid): extra_seconds}`` injection table, scaling law) plus
the machine-checkable ground truth (target vertices, culprit processes).
Resolution is deterministic: the same (scenario, scale, seed) always
yields bit-identical plans, which is what lets the bank assert accuracy
floors and the property tests assert run-to-run reproducibility.

Faults model the paper's evaluation faults at jax scale:

  * :class:`MoEImbalance`   — hot experts: a proc subset runs long in the
    MoE dispatch compute; the all-to-all exposes it as wait.
  * :class:`PipelineBubble` — one straggler stage; the ring neighbor
    exchange stalls the pipeline behind it.
  * :class:`DataStall`      — the input pipeline stalls a random proc
    subset in the first compute vertex of the step.
  * :class:`BatchSkew`      — serving: uneven per-proc batch occupancy
    scales the dominant decode compute multiplicatively.
  * :class:`SerialFraction` — Amdahl: part of the heaviest vertex does
    not parallelize; surfaces in the cross-scale slope fit.

Delays inject at COMPUTE vertices only — communication vertices are
where the replay engine *exposes* the delay as waiting, which is exactly
the symptom/cause split Algorithm 1's busy-time scoring must undo.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import COMP, LOOP, PSG
from repro_torch.core.inject import vectorized_base_times
from repro_torch.scenarios.source import StepTrace

Node = Tuple[int, int]


# ---------------------------------------------------------------------------
# target-vertex selection DSL
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VertexSel:
    """Declarative vertex pick: filter by kind/source, rank, index.

    ``rank_by``: "time" (measured base seconds, descending), "flops"
    (static FLOP count, descending) or "order" (top-level program order,
    ascending — index 0 is the first vertex of the step, the input
    pipeline's seat).  Resolution always restricts to the recorded PSG's
    top-level compute (the replay schedule's atomic units).
    """
    kinds: Tuple[str, ...] = (COMP, LOOP)
    source_contains: str = ""
    rank_by: str = "time"
    index: int = 0

    def resolve(self, psg: PSG, base: Dict[int, float]) -> int:
        tops = [v for vid in psg.children(psg.root)
                for v in (psg.vertices[vid],) if v.kind in self.kinds]
        if self.source_contains:
            hits = [v for v in tops if self.source_contains in v.source]
            tops = hits or tops               # soft filter: fall back whole
        if not tops:
            raise ValueError(f"no vertex matches {self}")
        if self.rank_by == "time":
            tops.sort(key=lambda v: -base.get(v.vid, 0.0))
        elif self.rank_by == "flops":
            tops.sort(key=lambda v: -v.flops)
        # "order": keep program order
        return tops[min(self.index, len(tops) - 1)].vid


@dataclasses.dataclass(frozen=True)
class ProcSpec:
    """Declarative culprit-process set, resolved at the target scale."""
    mode: str = "all"             # all | modrem | single | random
    stride: int = 1               # modrem: p % stride == rem
    rem: int = 0
    frac: float = 0.0             # random: fraction of procs; single: position
    count: int = 0                # random: |set| override (0: use frac)

    def resolve(self, n_procs: int, seed: int) -> np.ndarray:
        if self.mode == "all":
            return np.arange(n_procs)
        if self.mode == "modrem":
            return np.arange(n_procs)[np.arange(n_procs) % self.stride
                                      == self.rem]
        if self.mode == "single":
            return np.asarray([min(int(self.frac * n_procs),
                                   n_procs - 1)], int)
        if self.mode == "random":
            k = self.count or max(int(round(self.frac * n_procs)), 1)
            rng = np.random.default_rng(seed)
            return np.sort(rng.choice(n_procs, size=min(k, n_procs),
                                      replace=False))
        raise ValueError(f"unknown proc mode {self.mode!r}")


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultPlan:
    """A fault resolved against one (trace, PSG, scale, seed)."""
    channel: str                          # "abnormal" | "non_scalable"
    base_fn: Callable                     # vectorized (procs, vid) -> secs
    time_at_scale: Callable               # (procs, vid, n) -> secs
    inject: Dict[Node, float]
    target_vids: Tuple[int, ...]
    culprit_procs: np.ndarray             # at the target scale


def _base_table(trace: StepTrace, psg: PSG) -> np.ndarray:
    table = np.zeros(len(psg.vertices))
    for vid, t in trace.base.items():
        if 0 <= vid < table.size:
            table[vid] = t
    return table


def _ideal(table: np.ndarray, devices: int) -> Callable:
    """Ideal strong scaling anchored at the recording host's device count:
    the measured time IS the per-proc time at ``devices`` procs."""
    d = float(max(devices, 1))

    @vectorized_base_times
    def fn(procs, vid, n):
        t = table[vid] if 0 <= vid < table.size else 0.0
        return t * d / n

    return fn


def _bind(ts: Callable, n: int) -> Callable:
    @vectorized_base_times
    def fn(procs, vid):
        return ts(procs, vid, n)

    return fn


class Fault:
    """Base: subclasses override :meth:`plan`."""

    def plan(self, trace: StepTrace, psg: PSG, n_procs: int,
             seed: int) -> FaultPlan:
        raise NotImplementedError


def _delay_plan(trace: StepTrace, psg: PSG, n_procs: int, *, target: int,
                procs: np.ndarray, extra_frac: float) -> FaultPlan:
    """Additive per-proc delay at one compute vertex (abnormal channel):
    ``extra_frac`` of the ideally-scaled step time, so the injected delay
    keeps the same share of the step at every scale."""
    table = _base_table(trace, psg)
    ts = _ideal(table, trace.recorded_devices)
    extra = extra_frac * trace.step_time() * trace.recorded_devices / n_procs
    inject = {(int(p), target): extra for p in procs}
    return FaultPlan(channel="abnormal", base_fn=_bind(ts, n_procs),
                     time_at_scale=ts, inject=inject,
                     target_vids=(target,), culprit_procs=procs)


@dataclasses.dataclass(frozen=True)
class MoEImbalance(Fault):
    """Hot experts: the MoE dispatch compute runs long on a proc subset;
    the following all-to-all exposes the imbalance as wait everywhere
    else.  Ground truth is the dispatch vertex on the hot procs."""
    select: VertexSel = VertexSel(source_contains="moe.py", rank_by="time")
    procs: ProcSpec = ProcSpec("modrem", stride=16, rem=3)
    extra_frac: float = 0.5

    def plan(self, trace, psg, n_procs, seed):
        target = self.select.resolve(psg, trace.base)
        return _delay_plan(trace, psg, n_procs, target=target,
                           procs=self.procs.resolve(n_procs, seed),
                           extra_frac=self.extra_frac)


@dataclasses.dataclass(frozen=True)
class PipelineBubble(Fault):
    """One straggler stage: a single proc runs its heaviest compute long;
    the trace's collective-permute ring turns it into a pipeline bubble
    that stalls every stage behind it.  The straggler sits late in the
    ring (frac 0.9) so the wait chain from any stalled stage back to the
    culprit fits inside backtrack's path-length cap at bench scales."""
    select: VertexSel = VertexSel(rank_by="time")
    procs: ProcSpec = ProcSpec("single", frac=0.9)
    extra_frac: float = 0.6

    def plan(self, trace, psg, n_procs, seed):
        target = self.select.resolve(psg, trace.base)
        return _delay_plan(trace, psg, n_procs, target=target,
                           procs=self.procs.resolve(n_procs, seed),
                           extra_frac=self.extra_frac)


@dataclasses.dataclass(frozen=True)
class DataStall(Fault):
    """Input-pipeline stall: the FIRST compute vertex of the step (where
    host->device feeding lands) blocks a seeded random proc subset for a
    full step's worth of time — the device idles while the host feeds."""
    select: VertexSel = VertexSel(rank_by="order", index=0)
    procs: ProcSpec = ProcSpec("random", frac=0.05)
    extra_frac: float = 1.0

    def plan(self, trace, psg, n_procs, seed):
        target = self.select.resolve(psg, trace.base)
        return _delay_plan(trace, psg, n_procs, target=target,
                           procs=self.procs.resolve(n_procs, seed),
                           extra_frac=self.extra_frac)


@dataclasses.dataclass(frozen=True)
class BatchSkew(Fault):
    """Serving batch-size skew: a proc subset decodes oversized batches,
    scaling the dominant decode compute multiplicatively (imbalance, not
    a fixed delay — the skew grows with the work)."""
    select: VertexSel = VertexSel(rank_by="time")
    procs: ProcSpec = ProcSpec("modrem", stride=8, rem=1)
    factor: float = 0.9

    def plan(self, trace, psg, n_procs, seed):
        target = self.select.resolve(psg, trace.base)
        table = _base_table(trace, psg)
        ideal = _ideal(table, trace.recorded_devices)
        culprit = self.procs.resolve(n_procs, seed)
        factor = self.factor
        spec = self.procs

        @vectorized_base_times
        def ts(procs, vid, n):
            t = ideal(procs, vid, n)
            if vid == target:
                hot = np.isin(np.asarray(procs), spec.resolve(int(n), seed))
                return t * (1.0 + factor * hot)
            return t

        return FaultPlan(channel="abnormal", base_fn=_bind(ts, n_procs),
                         time_at_scale=ts, inject={},
                         target_vids=(target,), culprit_procs=culprit)


@dataclasses.dataclass(frozen=True)
class SerialFraction(Fault):
    """Amdahl: ``frac`` of the heaviest compute vertex does not
    parallelize.  Surfaces in the cross-scale log-log slope fit (the
    non-scalable channel); every process is equally guilty."""
    select: VertexSel = VertexSel(rank_by="time")
    frac: float = 0.55

    def plan(self, trace, psg, n_procs, seed):
        target = self.select.resolve(psg, trace.base)
        table = _base_table(trace, psg)
        d = float(max(trace.recorded_devices, 1))
        frac = self.frac

        @vectorized_base_times
        def ts(procs, vid, n):
            t = table[vid] if 0 <= vid < table.size else 0.0
            if vid == target:
                return t * (frac + (1.0 - frac) * d / n)
            return t * d / n

        return FaultPlan(channel="non_scalable", base_fn=_bind(ts, n_procs),
                         time_at_scale=ts, inject={},
                         target_vids=(target,),
                         culprit_procs=np.arange(n_procs))


FAULT_KINDS = {
    "moe_imbalance": MoEImbalance,
    "pipeline_bubble": PipelineBubble,
    "data_stall": DataStall,
    "batch_skew": BatchSkew,
    "serial_fraction": SerialFraction,
}

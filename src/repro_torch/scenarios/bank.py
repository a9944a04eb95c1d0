"""The ground-truth scenario bank (paper §VI evaluation methodology).

A :class:`Scenario` pairs one committed real-model :class:`StepTrace`
with one declarative :class:`~repro_torch.scenarios.faults.Fault` and a
:class:`GroundTruth` stating what a correct diagnosis must report — the
root-cause vertex (by construction, the fault's injection site), the
culprit process set, the expected vertex kinds, and the accuracy floors
the bench asserts.  :meth:`Scenario.run` executes the full pipeline —
instantiate the PSG at the target scale, resolve the fault, replay with
the array engine, detect (numpy or torch backend), backtrack, rank root
causes — and returns a :class:`ScenarioResult` that
:mod:`repro_torch.scenarios.score` turns into precision/recall/path-hit-rate.

Traces are committed JSON and the replay engine is numpy;
``backend="torch"`` routes the detection math through ``detect``'s
backend seam onto ``device`` (the CUDA kernels on a card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.backtrack import Path, backtrack, root_causes
from repro_torch.core.detect import (Abnormal, NonScalable, detect_abnormal,
                                     detect_non_scalable)
from repro_torch.core.graph import PPG, PSG
from repro_torch.core.inject import simulate, simulate_series
from repro_torch.scenarios.faults import (BatchSkew, DataStall, Fault, FaultPlan,
                                          MoEImbalance, PipelineBubble, ProcSpec,
                                          SerialFraction)
from repro_torch.scenarios.source import (CollectiveSpec, GroupPattern, StepTrace,
                                          instantiate_psg, load_trace)

Node = Tuple[int, int]

_TRACE_CACHE: Dict[str, StepTrace] = {}


def _trace(name: str) -> StepTrace:
    if name not in _TRACE_CACHE:
        _TRACE_CACHE[name] = load_trace(name)
    return _TRACE_CACHE[name]


@dataclasses.dataclass(frozen=True)
class GroundTruth:
    """What a correct diagnosis reports, and the floors the bench asserts.

    The root-cause VERTICES are resolved by the fault plan (its injection
    targets); ``expect_kinds`` sanity-checks their PSG kinds.  ``eval_k``
    is the root-cause report depth scored against (0: exactly the number
    of truth vertices — precision@k with k = |truth|).  ``procs_matter``
    is False on the non-scalable channel, where every process shares the
    serial fraction equally.
    """
    expect_kinds: Tuple[str, ...] = ("Comp", "Loop")
    procs_matter: bool = True
    eval_k: int = 0
    min_precision: float = 0.8
    min_recall: float = 0.8
    min_path_hit: float = 0.8


@dataclasses.dataclass
class ScenarioResult:
    """One end-to-end run: pipeline outputs + resolved ground truth."""
    scenario: str
    n_procs: int
    backend: Optional[str]       # as requested; None is the detectors' default
    seed: int
    channel: str
    psg: PSG
    ppg: PPG
    non_scalable: List[NonScalable]
    abnormal: List[Abnormal]
    paths: List[Path]
    reported: List[Tuple[Node, str, str]]     # root_causes output
    truth_vids: Tuple[int, ...]
    truth_procs: np.ndarray
    truth: GroundTruth

    def key(self) -> tuple:
        """Deterministic digest for reproducibility checks: every
        flagged/reported identity, bit-exact."""
        return (tuple((a.vid, a.proc, a.time) for a in self.abnormal),
                tuple((d.vid, d.slope) for d in self.non_scalable),
                tuple(tuple(p.nodes) for p in self.paths),
                tuple(n for n, _, _ in self.reported))


def _ladder(n_procs: int) -> List[int]:
    """Cross-scale series for the non-scalable channel: three octaves up
    to the target scale."""
    return [max(n_procs // 8, 2), max(n_procs // 4, 2),
            max(n_procs // 2, 2), n_procs]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One reproducible scaling-loss case: trace x fault x ground truth."""
    name: str
    trace: str
    fault: Fault
    truth: GroundTruth = GroundTruth()
    extra_collectives: Tuple[CollectiveSpec, ...] = ()
    seed: int = 0
    abnorm_thd: float = 1.3
    # abnormal report depth: wide enough that true-cause flags survive
    # next to the comm-wait symptom flags that co-rank with them
    top_k: int = 64

    def build(self, n_procs: int, seed: Optional[int] = None
              ) -> Tuple[PSG, FaultPlan, StepTrace]:
        """Instantiate the PSG at ``n_procs`` and resolve the fault."""
        trace = _trace(self.trace)
        if self.extra_collectives:
            trace = dataclasses.replace(
                trace, collectives=list(trace.collectives)
                + list(self.extra_collectives))
        psg = instantiate_psg(trace, n_procs)
        plan = self.fault.plan(trace, psg, n_procs,
                               self.seed if seed is None else seed)
        return psg, plan, trace

    def run(self, n_procs: int, *, backend: Optional[str] = None,
            device: Optional[str] = None,
            seed: Optional[int] = None,
            proc_mask: Optional[np.ndarray] = None) -> ScenarioResult:
        """``backend`` / ``device`` pass straight to the detectors: the
        default resolves as theirs does (the card where one exists, else
        numpy), and ``backend="torch"`` with no device runs on ``cuda``."""
        seed = self.seed if seed is None else seed
        psg, plan, trace = self.build(n_procs, seed)
        if plan.channel == "non_scalable":
            series = simulate_series(psg, _ladder(n_procs),
                                     plan.time_at_scale, seed=seed)
            ppg = series[n_procs]
            ns = detect_non_scalable(series, backend=backend, device=device,
                                     proc_mask=proc_mask)
        else:
            ppg = simulate(psg, n_procs, plan.base_fn, inject=plan.inject,
                           seed=seed).ppg
            ns = []
        ab = detect_abnormal(ppg, abnorm_thd=self.abnorm_thd,
                             top_k=self.top_k, backend=backend,
                             device=device, proc_mask=proc_mask)
        paths = backtrack(ppg, ns, ab)
        k = self.truth.eval_k or max(len(plan.target_vids), 1)
        reported = root_causes(paths, psg, top_k=k, ppg=ppg)
        return ScenarioResult(
            scenario=self.name, n_procs=n_procs, backend=backend, seed=seed,
            channel=plan.channel, psg=psg, ppg=ppg, non_scalable=ns,
            abnormal=ab, paths=paths, reported=reported,
            truth_vids=tuple(plan.target_vids),
            truth_procs=np.asarray(plan.culprit_procs), truth=self.truth)


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------

_RING = CollectiveSpec(kind="collective-permute", bytes=1 << 16, count=1,
                       pattern=GroupPattern("ring"), order=-1)

SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    # Path-hit floors are per scenario: symptom paths that backtrack
    # from a step-end collective follow max-time data preds through the
    # REAL profiler edge topology, which does not always traverse an
    # early-step cause — the busy-anomaly root-cause ranking is what
    # restores precision/recall to 1.0 there (Algorithm 1's known
    # symptom/cause split).  Floors assert non-regression of the walk.
    Scenario(
        name="moe_alltoall_imbalance",
        trace="moe_train",
        fault=MoEImbalance(),
        truth=GroundTruth(expect_kinds=("Comp",), min_path_hit=0.4)),
    Scenario(
        # The recorded trace's own collective-permute ring carries the
        # bubble; no synthetic collective is appended.  Path-hit floor is
        # intentionally low: the trace's HLO orders all-reduces BEFORE
        # the ring, so the straggler's delay is absorbed (exposed as
        # wait) at the first all-reduce and the ring sees synced arrivals
        # — what it exposes at bench scale is its own O(n) sequential
        # per-pair ripple, whose flags legitimately attribute to
        # ring-tail processes.  The walk still produces the direct
        # (culprit, target) path, and busy-anomaly ranking keeps
        # precision/recall at 1.0.
        name="pipeline_bubble_straggler",
        trace="tinyllama_train",
        fault=PipelineBubble(),
        truth=GroundTruth(expect_kinds=("Comp", "Loop"),
                          min_path_hit=0.05)),
    Scenario(
        name="data_pipeline_stall",
        trace="tinyllama_train",
        fault=DataStall(),
        truth=GroundTruth(expect_kinds=("Comp", "Loop"),
                          min_path_hit=0.4)),
    Scenario(
        name="serving_batch_skew",
        trace="tinyllama_decode",
        fault=BatchSkew(),
        truth=GroundTruth(expect_kinds=("Comp", "Loop"),
                          min_path_hit=0.8)),
    Scenario(
        name="amdahl_serial_fraction",
        trace="tinyllama_train",
        fault=SerialFraction(),
        truth=GroundTruth(expect_kinds=("Comp", "Loop"),
                          procs_matter=False, min_path_hit=0.9)),
    Scenario(
        name="moe_input_stall",
        trace="moe_train",
        fault=DataStall(procs=ProcSpec("random", frac=0.08),
                        extra_frac=0.5),
        seed=7,
        truth=GroundTruth(expect_kinds=("Comp", "Loop"),
                          min_path_hit=0.5)),
)}

# the two fastest end-to-end cases: `make scenario-smoke` coverage
SMOKE_SCENARIOS = ("data_pipeline_stall", "serving_batch_skew")


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r} (have: {sorted(SCENARIOS)})")

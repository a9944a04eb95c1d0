"""Ground-truth scenario bank: real-trace PPGs with injected root causes.

Public API (traces are recorded by the JAX package,
``python -m repro.scenarios.record``, and replayed here unchanged):

  * :data:`SCENARIOS` / :func:`get_scenario` — the bank;
  * :class:`Scenario` / :class:`GroundTruth` / :class:`ScenarioResult`;
  * :func:`run_and_score` / :func:`score_result` / :class:`Score`;
  * :class:`StepTrace` / :func:`load_trace` / :func:`list_traces` /
    :func:`instantiate_psg` — the committed-trace layer;
  * the declarative fault kinds in :mod:`repro_torch.scenarios.faults`.
"""
from repro_torch.scenarios.bank import (SCENARIOS, SMOKE_SCENARIOS, GroundTruth,
                                        Scenario, ScenarioResult, get_scenario)
from repro_torch.scenarios.faults import (FAULT_KINDS, BatchSkew, DataStall, Fault,
                                          FaultPlan, MoEImbalance, PipelineBubble,
                                          ProcSpec, SerialFraction, VertexSel)
from repro_torch.scenarios.score import (Score, run_and_score, score_nodes,
                                         score_result)
from repro_torch.scenarios.source import (CollectiveSpec, GroupPattern, StepTrace,
                                          classify_groups, instantiate_psg,
                                          list_traces, load_trace)

__all__ = [
    "SCENARIOS", "SMOKE_SCENARIOS", "GroundTruth", "Scenario",
    "ScenarioResult", "get_scenario",
    "FAULT_KINDS", "BatchSkew", "DataStall", "Fault", "FaultPlan",
    "MoEImbalance", "PipelineBubble", "ProcSpec", "SerialFraction",
    "VertexSel",
    "Score", "run_and_score", "score_nodes", "score_result",
    "CollectiveSpec", "GroupPattern", "StepTrace", "classify_groups",
    "instantiate_psg", "list_traces", "load_trace",
]

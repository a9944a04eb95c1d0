"""Root-cause localization scoring for scenario runs.

Turns one :class:`~repro_torch.scenarios.bank.ScenarioResult` into a
:class:`Score` — the three accuracy axes the bench table asserts:

  * ``precision``     — fraction of REPORTED root-cause nodes that hit the
    ground truth (the report is ``root_causes``'s top-k, with k = number
    of truth vertices by default — precision@k);
  * ``recall``        — fraction of truth VERTICES covered by a correct
    reported node;
  * ``path_hit_rate`` — fraction of backtrack paths that reach the
    planted cause: touch a truth VERTEX, or (when processes matter)
    touch a culprit PROCESS at any vertex.  The process clause is
    deliberate — a ring-bubble walk chains waits back to the straggler
    process and ends at its comm/tail vertices, which localizes the
    cause to the right process even when the max-time pred chain misses
    the injected vertex itself.  A walk that dies at the symptom scores
    0 on both clauses.

A reported node ``(proc, vid)`` is correct when ``vid`` is a truth vertex
AND — on scenarios where ``procs_matter`` — ``proc`` is in the culprit
set.  Degraded fleets (``proc_mask``) shrink the culprit set to its live
intersection first: a diagnosis cannot (and must not) report a dead
process.  Conventions at the edges, pinned by tests: an empty report has
precision 1.0 (nothing wrong was claimed) and, when truth survives the
mask, recall 0.0; an empty live-truth set scores 1.0 everywhere (there
is nothing left to find).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.scenarios.bank import ScenarioResult

Node = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Score:
    precision: float
    recall: float
    path_hit_rate: float
    n_reported: int
    n_truth: int

    def passes(self, truth) -> bool:
        """Against a :class:`~repro_torch.scenarios.bank.GroundTruth`'s floors."""
        return (self.precision >= truth.min_precision
                and self.recall >= truth.min_recall
                and self.path_hit_rate >= truth.min_path_hit)

    def row(self) -> str:
        return (f"precision={self.precision:.3f} recall={self.recall:.3f} "
                f"path_hit={self.path_hit_rate:.3f} "
                f"reported={self.n_reported} truth={self.n_truth}")


def score_nodes(reported: Sequence[Node], truth_vids: Iterable[int],
                truth_procs: Optional[Sequence[int]],
                paths: Sequence[Sequence[Node]] = ()) -> Score:
    """Score a plain node list — the testable core of :func:`score_result`.

    ``truth_procs=None`` means process identity does not matter (the
    non-scalable channel).  ``paths`` are node sequences; a path hits
    when any of its nodes lies on a truth vertex.
    """
    tvids = set(int(v) for v in truth_vids)
    tprocs = None if truth_procs is None else set(
        int(p) for p in truth_procs)
    n_truth = len(tvids)
    if n_truth == 0 or (tprocs is not None and not tprocs):
        return Score(1.0, 1.0, 1.0, len(reported), n_truth)

    def correct(node: Node) -> bool:
        proc, vid = node
        return vid in tvids and (tprocs is None or proc in tprocs)

    hits = [n for n in reported if correct(n)]
    precision = len(hits) / len(reported) if reported else 1.0
    recall = len({vid for _, vid in hits}) / n_truth

    def path_hits(p: Sequence[Node]) -> bool:
        return any(vid in tvids for _, vid in p) or (
            tprocs is not None and any(proc in tprocs for proc, _ in p))

    path_hit = (sum(1 for p in paths if path_hits(p)) / len(paths)
                if paths else 0.0)
    return Score(precision, recall, path_hit, len(reported), n_truth)


def score_result(result: ScenarioResult,
                 proc_mask: Optional[np.ndarray] = None) -> Score:
    """Score one scenario run against its resolved ground truth.

    ``proc_mask`` (same (n_procs,) bool the run's detection used, if any)
    restricts the culprit set to live processes.
    """
    truth_procs: Optional[Sequence[int]] = result.truth_procs
    if not result.truth.procs_matter:
        truth_procs = None
    elif proc_mask is not None:
        live = np.flatnonzero(np.asarray(proc_mask, bool))
        truth_procs = np.intersect1d(result.truth_procs, live)
    return score_nodes([n for n, _, _ in result.reported],
                       result.truth_vids, truth_procs,
                       [list(p.nodes) for p in result.paths])


def run_and_score(scenario, n_procs: int, *, backend: Optional[str] = None,
                  device: Optional[str] = None,
                  seed: Optional[int] = None,
                  proc_mask: Optional[np.ndarray] = None
                  ) -> Tuple[ScenarioResult, Score]:
    """Convenience: one end-to-end run + its score."""
    result = scenario.run(n_procs, backend=backend, device=device,
                          seed=seed, proc_mask=proc_mask)
    return result, score_result(result, proc_mask=proc_mask)

"""Multi-run regression store: persist, align, diff, cluster, report.

The fleet question behind this package is "why did today's run get
slower than yesterday's, and which of my processes behave differently" —
one-shot detection (detect/backtrack over a single PPG) answers neither.
The pieces:

* :class:`~repro_torch.runs.store.RunStore` — persists (PSG, perf store,
  comm index, detect output, scaling curves, metadata) per run through
  the ``to_tree``/``from_tree`` seam and ``repro_torch.checkpoint.store`` —
  the SAME persistence path the monitor's crash snapshots use.
* :func:`~repro_torch.runs.align.align_psgs` — matches vertices across runs
  whose graphs drifted, by stable (kind, name, path-from-root)
  signatures with explicit added/removed sets — never positionally.
* :func:`~repro_torch.runs.diff.diff_runs` — per-vertex scaling-curve deltas
  and regression flags, reusing the detect slope machinery (the numpy
  fit, or the torch twin on a device, behind
  ``detect._resolve_backend``).
* :func:`~repro_torch.runs.cluster.cluster_procs` — groups processes by
  behavior vector (per-vertex time + counter signature) so an 8k–64k
  proc run stores and diffs as K representatives + a membership map.
* :func:`~repro_torch.runs.report.render_regression_report` — names the top
  regressed vertices and the regressed cluster, and backtracks the
  regressed representative through the existing ``backtrack`` path.

Importing the package does not import torch; the torch slope fit
engages only through ``diff_runs(backend=..., device=...)``.
"""
from repro_torch.runs.align import Alignment, align_psgs, vertex_signatures
from repro_torch.runs.cluster import (Clustering, behavior_matrix,
                                      cluster_procs, representative_ppg)
from repro_torch.runs.diff import (RunDiff, VertexDelta, diff_runs,
                                   scaling_curves)
from repro_torch.runs.report import regressed_cluster, render_regression_report
from repro_torch.runs.store import (RUN_SCHEMA_VERSION, RunRecord, RunStore,
                                    run_metadata)

__all__ = [
    "Alignment", "align_psgs", "vertex_signatures",
    "Clustering", "behavior_matrix", "cluster_procs", "representative_ppg",
    "RunDiff", "VertexDelta", "diff_runs", "scaling_curves",
    "regressed_cluster", "render_regression_report",
    "RUN_SCHEMA_VERSION", "RunRecord", "RunStore", "run_metadata",
]

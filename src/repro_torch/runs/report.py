"""Regression report: name the vertices, the cluster, and the path.

Turns a :class:`~repro_torch.runs.diff.RunDiff` into the text a fleet
operator reads after "today got slower":

1. the top regressed vertices (ranked by excess time x share),
2. the **regressed cluster** — which behavior class of processes the
   regression lives in, when the candidate run was recorded clustered,
3. a root-cause walk from the regressed representative through the
   EXISTING :func:`repro_torch.core.backtrack.backtrack` — the representative
   sub-PPG carries real comm structure (collective groups intersected,
   p2p remapped), so the walk crosses dependence edges exactly like a
   one-shot diagnosis would.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.backtrack import backtrack
from repro_torch.core.detect import Abnormal
from repro_torch.core.report import _fmt_node
from repro_torch.runs.diff import RunDiff, VertexDelta
from repro_torch.runs.store import RunRecord


def regressed_cluster(cand: RunRecord, diff: RunDiff, *,
                      rank: int = 0) -> Optional[int]:
    """Cluster id carrying the ``rank``-th flagged regression.

    The candidate's stored rows are cluster representatives; the
    regressed cluster is the one whose representative is slowest —
    relative to the base run's merged time — at the flagged vertex.
    Returns None when the run was not clustered or nothing regressed."""
    if cand.clustering is None or cand.ppg is None:
        return None
    if rank >= len(diff.regressions):
        return None
    d = diff.regressions[rank]
    row, _ = _worst_row(cand, d)
    return row


def _worst_row(cand: RunRecord, d: VertexDelta) -> Tuple[int, float]:
    """(row, time) of the stored row slowest at the flagged vertex."""
    t = np.asarray(cand.ppg.times_matrix(), float)[:, d.vid_cand]
    row = int(np.argmax(t))
    return row, float(t[row])


def _cluster_lines(cand: RunRecord, diff: RunDiff) -> List[str]:
    cl = cand.clustering
    k = regressed_cluster(cand, diff)
    if cl is None or k is None:
        return []
    members = cl.members(k)
    sample = ", ".join(f"p{p}" for p in members[:8].tolist())
    if members.size > 8:
        sample += f", … and {members.size - 8} more"
    return [
        "## Regressed cluster",
        f"  cluster {k} of {cl.n_clusters} "
        f"(representative p{int(cl.rep_procs[k])}, "
        f"{members.size}/{cl.n_procs} procs, "
        f"{cl.compression():.0f}x row compression)",
        f"  members: {sample}",
        "",
    ]


def _backtrack_lines(cand: RunRecord, diff: RunDiff, *,
                     max_paths: int) -> List[str]:
    """Root-cause walks from the worst stored row of each flagged
    vertex, as synthetic abnormal starts over the candidate PPG."""
    ppg = cand.ppg
    t = np.asarray(ppg.times_matrix(), float)
    starts: List[Abnormal] = []
    for d in diff.regressions[:max_paths]:
        col = t[:, d.vid_cand]
        row = int(np.argmax(col))
        pos = col[col > 0.0]
        typical = float(np.median(pos)) if pos.size else 0.0
        v = ppg.psg.vertices[d.vid_cand]
        starts.append(Abnormal(
            vid=d.vid_cand, proc=row, time=float(col[row]),
            typical=typical,
            ratio=float(col[row]) / typical if typical > 0 else float("inf"),
            kind=v.kind, name=v.name, source=v.source))
    if not starts:
        return []
    cl = cand.clustering
    label = (lambda r: int(cl.rep_procs[r])) if cl is not None \
        else (lambda r: r)
    lines = ["## Root-cause walk (from regressed representatives)"]
    for i, p in enumerate(backtrack(ppg, [], starts)):
        lines.append(f"  path {i} [{p.start_reason}]:")
        for proc, vid in p.nodes:
            lines.append(f"    <- {_fmt_node(ppg.psg, (label(proc), vid))}")
    lines.append("")
    return lines


def render_regression_report(base: RunRecord, cand: RunRecord,
                             diff: RunDiff, *, top_k: int = 10,
                             max_paths: int = 3,
                             title: str = "Cross-run regression report"
                             ) -> str:
    """Text regression report; see module docstring."""
    lines: List[str] = [title, "=" * len(title), ""]
    meta_bits = []
    for tag, rec in (("base", base), ("cand", cand)):
        commit = str(rec.meta.get("commit", ""))[:12]
        bit = f"{tag} {rec.run_id} (scale {rec.scale}"
        if commit:
            bit += f", commit {commit}"
        meta_bits.append(bit + ")")
    lines.append("  ".join(meta_bits))
    lines.append(f"compared at {diff.base_scale} -> {diff.cand_scale} procs"
                 f"   slope backend: {diff.backend}")
    lines.append("")

    if diff.added or diff.removed:
        lines.append("## Graph drift")
        for name in diff.added:
            lines.append(f"  + {name}")
        for name in diff.removed:
            lines.append(f"  - {name}")
        lines.append("")

    lines.append(f"## Regressed vertices "
                 f"({len(diff.regressions)} of {len(diff.deltas)} matched)")
    if not diff.regressions:
        lines.append("  (none)")
    for d in diff.regressions[:top_k]:
        lines.append(f"  - {d.describe()}")
    if len(diff.regressions) > top_k:
        lines.append(f"  … and {len(diff.regressions) - top_k} more")
    lines.append("")

    lines.extend(_cluster_lines(cand, diff))
    if diff.regressions and cand.ppg is not None:
        lines.extend(_backtrack_lines(cand, diff, max_paths=max_paths))
    return "\n".join(lines).rstrip() + "\n"

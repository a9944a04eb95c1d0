"""Root-cause reporting (the ScalAna-viewer analogue, text mode).

Renders detections + backtracking paths with source locations and the
PMU-analogue counters, in the spirit of the paper's GUI: root-cause
vertices, their calling paths, and the code snippets they map to.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.backtrack import Path, root_causes
from repro_torch.core.detect import Abnormal, NonScalable
from repro_torch.core.graph import PPG, PSG


def _fmt_node(psg: PSG, node) -> str:
    proc, vid = node
    v = psg.vertices[vid]
    loc = f" @ {v.source}" if v.source else ""
    return f"[p{proc}] {v.kind}:{v.name}{loc}"


def render_report(ppg: PPG, non_scalable: Sequence[NonScalable],
                  abnormal: Sequence[Abnormal], paths: Sequence[Path],
                  *, title: str = "ScalAna scaling-loss report",
                  max_abnormal: int = 10,
                  coverage: Optional[str] = None) -> str:
    """Text report of the full diagnosis.

    ``max_abnormal`` caps the abnormal-vertex listing; when more were
    flagged, the listing ends with an explicit "… and N more" line
    instead of truncating silently.

    ``coverage`` is an optional fleet-coverage annotation (the always-on
    monitor's degraded-fleet contract: every report states how much of
    the fleet it covers), rendered right under the header counts."""
    psg = ppg.psg
    lines: List[str] = [title, "=" * len(title), ""]

    lines.append(f"processes: {ppg.n_procs}   vertices: "
                 f"{len(psg.vertices)}   comm edges: {len(ppg.comm_edges)}")
    if coverage is not None:
        lines.append(coverage)
    lines.append("")

    lines.append("## Non-scalable vertices (log-log slope vs ideal -1.0)")
    if not non_scalable:
        lines.append("  (none)")
    for d in non_scalable:
        lines.append(
            f"  - v{d.vid} {d.kind}:{d.name} slope={d.slope:+.2f} "
            f"share={100 * d.share:.1f}% {d.source}")
    lines.append("")

    lines.append("## Abnormal vertices (AbnormThd exceeded)")
    if not abnormal:
        lines.append("  (none)")
    for a in abnormal[:max_abnormal]:
        lines.append(
            f"  - v{a.vid} p{a.proc} {a.kind}:{a.name} "
            f"t={1e3 * a.time:.3f}ms typical={1e3 * a.typical:.3f}ms "
            f"x{a.ratio:.2f} {a.source}")
    if len(abnormal) > max_abnormal:
        lines.append(f"  … and {len(abnormal) - max_abnormal} more")
    lines.append("")

    lines.append("## Backtracking root-cause paths")
    if not paths:
        lines.append("  (none)")
    for i, p in enumerate(paths):
        lines.append(f"  path {i} [{p.start_reason}]:")
        for node in p.nodes:
            proc, vid = node
            vec = ppg.perf.get(node)
            t = f" t={1e3 * vec.time:.3f}ms" if vec else ""
            w = (f" wait={1e3 * vec.counters['wait_s']:.3f}ms"
                 if vec and vec.counters.get("wait_s") else "")
            lines.append(f"    <- {_fmt_node(psg, node)}{t}{w}")
    lines.append("")

    lines.append("## Root causes")
    for node, name, source in root_causes(paths, psg, ppg=ppg):
        proc, vid = node
        vec = ppg.perf.get(node)
        counters = ""
        if vec and vec.counters:
            keys = [k for k in ("flops", "bytes", "comm_bytes") if
                    vec.counters.get(k)]
            counters = "  " + " ".join(
                f"{k}={vec.counters[k]:.3g}" for k in keys)
        lines.append(f"  * p{proc} v{vid} {name} @ {source or '<unknown>'}"
                     f"{counters}")
    return "\n".join(lines)

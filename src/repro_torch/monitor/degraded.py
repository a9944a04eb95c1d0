"""Degraded-fleet compaction: the PPG restricted to LIVE processes.

When hosts die or go stale, the monitor must keep producing correct
results for the sub-fleet that is still reporting.  Detection handles
this with row masks (``detect_abnormal(..., proc_mask=)`` — exact
row-subsetting, threaded down to the device kernels); backtracking walks
the explicit graph, so here the graph itself is compacted:
:func:`live_subppg` gathers the live rows into a dense store (via the
``extract_rows``/``apply_rows`` seam), intersects every collective
participant group with the live set, filters p2p edges touching dead
processes, and remaps the surviving procs to ``0..n_live-1``.  The
result is exactly the PPG a one-shot run would build over a fleet that
never contained the dead hosts — the acceptance contract for degraded
monitoring — and :func:`remap_paths` lifts the walk's local proc indices
back to global ones for reporting.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.backtrack import Path
from repro_torch.core.graph import CommIndex, PPG, PerfStore
from repro_torch.core.shard import ShardedStore


def live_subppg(ppg: PPG, live_idx: np.ndarray) -> PPG:
    """The PPG restricted to the (sorted, global) ``live_idx`` processes.

    Perf rows are gathered through the row-block seam (sharded stores
    extract per shard; the stacked matrix is never built), comm groups
    are intersected with the live set (groups left with < 2 members
    vanish — a collective with one live participant constrains nothing),
    and p2p edges keep only live-to-live pairs.  Proc ``live_idx[i]``
    becomes proc ``i`` of the sub-PPG."""
    live_idx = np.asarray(live_idx, np.intp)
    n_live = int(live_idx.size)
    psg = ppg.psg
    V = len(psg.vertices)
    pos = np.full(ppg.n_procs, -1, np.intp)
    pos[live_idx] = np.arange(n_live)

    sub = PerfStore(max(n_live, 1), V)
    perf = ppg.perf
    if isinstance(perf, ShardedStore):
        for sh in perf.shards:
            sel = (live_idx >= sh.proc_start) & (live_idx < sh.proc_stop)
            if sel.any():
                blk = sh.extract_rows(live_idx[sel] - sh.proc_start)
                sub.apply_rows(blk, rows=np.nonzero(sel)[0])
    elif n_live:
        sub.apply_rows(perf.extract_rows(live_idx), rows=np.arange(n_live))
    sub.clear_dirty()

    comm = CommIndex()
    for vid in range(V):
        for group in ppg.comm.groups_of(vid):
            kept = [int(pos[p]) for p in group if pos[p] >= 0]
            if len(kept) >= 2:
                comm.add_group(vid, kept)
    for (sp, sv), (dp, dv) in ppg.comm.p2p_edges():
        if pos[sp] >= 0 and pos[dp] >= 0:
            comm.add_p2p((int(pos[sp]), sv), (int(pos[dp]), dv))

    out = PPG(psg, n_live, sub, meta=dict(ppg.meta))
    out.comm = comm
    return out


def remap_paths(paths: Sequence[Path], live_idx: np.ndarray) -> List[Path]:
    """Lift sub-PPG paths (local procs) back to global proc indices."""
    live_idx = np.asarray(live_idx, np.intp)
    return [Path(nodes=[(int(live_idx[p]), v) for p, v in path.nodes],
                 start_reason=path.start_reason) for path in paths]

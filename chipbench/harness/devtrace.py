"""Reduction of a ``torch.profiler`` trace of the measured window: the
device's busy time (the union of the intervals in which a kernel, copy
or fill ran), the idle gaps inside the window named by what the host was
doing in each (the innermost host event across its middle), and the
device time by operation name.  Read straight from the profiler's
Kineto events; ``key_averages()`` is far too slow for a step of ~10^5
kernels."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "chipbench.window"
NAME_CHARS = 160


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def reduce(events, top: int = 10) -> Optional[Dict]:
    """``events``: ``prof.profiler.kineto_results.events()`` of a profile
    that holds one ``record_function(WINDOW)`` around the window.  None
    where the trace holds no window or no device operation."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[str, int, int]] = []
    host_s, host_e, host_n = [], [], []
    w0 = w1 = None
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            dev.append((e.name(), s, s + d))
        elif e.name() == WINDOW:
            w0, w1 = s, s + d
        else:
            host_s.append(s)
            host_e.append(s + d)
            host_n.append(e)
    # a host range (record_function) is mirrored on the device's timeline
    # under its own name: a range, not work
    ranges = {e.name() for e in host_n} | {WINDOW}
    dev = [x for x in dev if x[0] not in ranges]
    if w0 is None or not dev:
        return None
    starts = np.array([s for _, s, _ in dev], dtype=np.int64)
    ends = np.array([e for _, _, e in dev], dtype=np.int64)
    inside = (ends > w0) & (starts < w1)
    if not inside.any():
        return None
    order = np.argsort(starts[inside], kind="stable")
    s_in = np.clip(starts[inside][order], w0, w1)
    e_in = np.clip(ends[inside][order], w0, w1)
    # union of intervals: a new run starts where a start passes every
    # earlier end
    run_end = np.maximum.accumulate(e_in)
    new = np.ones(len(s_in), dtype=bool)
    new[1:] = s_in[1:] > run_end[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s_in) - 1)
    seg_s, seg_e = s_in[first], run_end[last]
    busy_ns = int((seg_e - seg_s).sum())
    gap_s = np.concatenate([[w0], seg_e])
    gap_e = np.concatenate([seg_s, [w1]])
    gap_len = gap_e - gap_s
    biggest = np.argsort(-gap_len, kind="stable")[:top]
    biggest = [int(i) for i in biggest if gap_len[i] > 0]

    hs = np.array(host_s, dtype=np.int64)
    he = np.array(host_e, dtype=np.int64)
    gaps = []
    for i in biggest:
        mid = (gap_s[i] + gap_e[i]) // 2
        cover = np.flatnonzero((hs <= mid) & (he >= mid))
        if cover.size:
            j = cover[np.argmin(he[cover] - hs[cover])]
            what = _short(host_n[j].name())
        else:
            what = "host: no recorded event"
        gaps.append([what, float(gap_len[i]) / 1e9])

    per_name: Dict[str, float] = {}
    for (name, s, e), keep in zip(dev, inside):
        if keep:
            per_name[name] = per_name.get(name, 0.0) + (min(e, w1)
                                                        - max(s, w0)) / 1e9
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "by_name": per_name,
            "device_ops": [[_short(n), t] for n, t in ops[:top]],
            "idle_gaps": gaps}

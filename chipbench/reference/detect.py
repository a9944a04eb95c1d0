"""Plain NumPy abnormal-vertex detection (ScalAna's AbnormThd rule): a
process's time at a top-level vertex is abnormal when it exceeds
``thd`` times the median over processes and the excess is at least
``min_share`` of the slowest process's step; a vertex whose median is 0
is abnormal where its time alone is that share.  The winners are ranked
by their excess over the median, ties in vertex-major order."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def abnormal_pairs(t: np.ndarray, top: Sequence[int], thd: float,
                   min_share: float, top_k: int) -> List[Tuple[int, int]]:
    """(vertex, process) winners of a (processes, vertices) time matrix."""
    step = float(t[:, list(top)].sum(axis=1).max()) if len(top) else 0.0
    step = step or 1e-12
    med = np.median(t, axis=0)
    seen = t.max(axis=0) > 0.0
    over = (med > 0.0) & (t > thd * med) & ((t - med) / step >= min_share)
    dead = (med == 0.0) & (t / step >= min_share)
    flags = (over | dead) & seen
    pairs = [(int(v), int(p)) for v, p in np.argwhere(flags.T)]
    excess = [t[p, v] - med[v] for v, p in pairs]
    order = sorted(range(len(pairs)), key=lambda i: -excess[i])
    return [pairs[i] for i in order[:top_k]]

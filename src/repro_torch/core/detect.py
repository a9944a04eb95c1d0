"""Location-aware problematic vertex detection (paper §IV-A).

* Non-scalable vertices: per-vertex performance across job scales, merged
  across processes (mean/median/max/cluster strategies), fitted with a
  log-log model t ~ a * p^b; vertices whose growth rate deviates from the
  ideal slope and whose share of total time is significant are flagged.

* Abnormal vertices: per-vertex times across processes at one scale;
  processes above AbnormThd x median are flagged.

Complexity: both detectors are vectorized over the PPG's dense (n_procs,
n_vertices) time matrices — cross-process merges, the log-log slope fit,
and abnormality thresholding are batched reductions, O(P*V) work with no
per-(proc, vertex) Python loops.  Only flagged entries (<= top_k in
practice) materialize Python objects.

Backends: the detection math runs either as numpy on the host or as the
fused torch ops (:mod:`repro_torch.core.detect_torch` — all jittable merge
strategies batched into one stacked (S, P, V) computation, run by
hand-written CUDA kernels on a card and by their plain torch versions on
the CPU).  ``backend=`` on each detector selects it explicitly ("numpy" /
"torch", with ``device=`` picking the torch device, ``cuda`` unless the
CPU is asked for); the default "auto" takes the torch path on the card
whenever a CUDA card exists, and numpy where there is none.  The
``SCALANA_DETECT_BACKEND`` environment variable overrides the default.

Merge strategies (``MERGE_STRATEGIES``): "mean", "median", "max", "p0",
"cluster", and variance-weighted "var" (readings weighted 1/time_var —
noisy processes count less).  "median"/"cluster" need data-dependent
per-column cuts and always run on the numpy path.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import COMM, COMP, LOOP, PPG
from repro_torch.core.shard import ShardedStore, TorchShardView

MERGE_STRATEGIES = ("mean", "median", "max", "p0", "cluster", "var")

# strategies the torch backend computes; the tuple order defines the row
# layout of the fused ops' stacked merge output
JIT_STRATEGIES = ("mean", "max", "p0", "var")

# inverse-variance weights are 1/(var + VAR_EPS): a zero-variance reading
# gets (effectively infinite) weight, all-zero variance degrades to "mean"
VAR_EPS = 1e-18


def _resolve_backend(backend: Optional[str], device=None):
    """Return ``(detect_torch, torch.device)`` for the torch path, or
    ``(None, None)`` for numpy.

    "torch" runs the fused torch ops on ``device`` — ``cuda`` when none is
    given, which raises where there is no card (the CPU must be asked for
    with ``device="cpu"``).  "auto" (the default) keeps the accelerator
    path for where one exists: the torch path when the target device
    (``device``, else ``cuda``) is an available CUDA card, otherwise
    numpy.  "numpy" never touches torch.
    """
    from_env = backend is None
    if from_env:
        backend = os.environ.get("SCALANA_DETECT_BACKEND", "auto")
    backend = str(backend).strip().lower()
    if backend not in ("numpy", "torch", "auto"):
        origin = " (from SCALANA_DETECT_BACKEND)" if from_env else ""
        raise ValueError(
            f"unknown detect backend{origin}: {backend!r}; valid values "
            f"are 'numpy', 'torch', 'auto'")
    if backend == "numpy":
        return None, None
    if backend == "auto":
        import torch
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None, None
    from repro_torch.core import detect_torch
    return detect_torch, TorchShardView.resolve_device(device)


def _norm_mask(proc_mask, n_procs: int) -> Optional[np.ndarray]:
    """Validate a live-process mask; return the live row indices.

    ``None`` (or an all-live mask) means no degradation and returns None.
    Masked detection is exact ROW-SUBSETTING, not zeroing: a dead host's
    rows may hold stale non-zero readings, and the cross-process median
    counts zeros, so only excluding the rows outright reproduces a
    one-shot run over a store that never contained them.
    """
    if proc_mask is None:
        return None
    m = np.asarray(proc_mask, bool)
    if m.shape != (n_procs,):
        raise ValueError(f"proc_mask shape {m.shape} != ({n_procs},)")
    if m.all():
        return None
    return np.nonzero(m)[0]


@dataclasses.dataclass
class NonScalable:
    vid: int
    slope: float                 # d log t / d log p  (ideal strong-scaling: -1)
    share: float                 # fraction of total step time at max scale
    score: float                 # ranking key
    times: Dict[int, float]      # scale -> merged time
    kind: str = ""
    name: str = ""
    source: str = ""


@dataclasses.dataclass
class Abnormal:
    vid: int
    proc: int
    time: float
    typical: float               # median across processes
    ratio: float
    kind: str = ""
    name: str = ""
    source: str = ""


def _merge(times: Sequence[float], strategy: str,
           variances: Optional[Sequence[float]] = None) -> float:
    """Scalar reference merge (see ``_merge_matrix`` for the batched path)."""
    arr = np.asarray([t for t in times if t > 0.0])
    if arr.size == 0:
        return 0.0
    if strategy == "mean":
        return float(arr.mean())
    if strategy == "median":
        return float(np.median(arr))
    if strategy == "max":
        return float(arr.max())
    if strategy == "p0":
        # proc-0's reading when alive; a dead proc-0 (t == 0) falls back to
        # the mean of live readings instead of silently dropping the vertex
        return float(times[0]) if times[0] > 0.0 else float(arr.mean())
    if strategy == "var":
        # inverse-variance weighting: noisy processes count less; with no
        # variance data every weight is equal and this degrades to "mean"
        var = np.zeros(len(times)) if variances is None \
            else np.asarray(variances, float)
        live = np.asarray(times) > 0.0
        w = 1.0 / (var[live] + VAR_EPS)
        return float((w * np.asarray(times)[live]).sum() / w.sum())
    if strategy == "cluster":
        # 2-means along sorted values; report the larger cluster's mean
        s = np.sort(arr)
        best_cut, best_gap = None, -1.0
        for i in range(1, s.size):
            gap = s[i] - s[i - 1]
            if gap > best_gap:
                best_gap, best_cut = gap, i
        hi = s[best_cut:] if best_cut is not None else s
        return float(hi.mean())
    raise ValueError(strategy)


def _merge_matrix(t: np.ndarray, strategy: str,
                  var: Optional[np.ndarray] = None) -> np.ndarray:
    """Columnwise ``_merge`` over a (n_procs, V) time matrix -> (V,).

    ``var`` is the matching (n_procs, V) time-variance matrix, used only by
    the variance-weighted "var" strategy."""
    n_procs, V = t.shape
    pos = t > 0.0
    cnt = pos.sum(axis=0)
    any_pos = cnt > 0
    if strategy in ("mean", "p0"):
        s = t.sum(axis=0, where=pos)
        mean = np.divide(s, cnt, out=np.zeros(V), where=any_pos)
        if strategy == "mean":
            return mean
        p0 = t[0] if n_procs else np.zeros(V)
        return np.where(p0 > 0.0, p0, mean)
    if strategy == "median":
        masked = np.where(pos, t, np.nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            med = np.nanmedian(masked, axis=0)
        return np.where(any_pos, med, 0.0)
    if strategy == "max":
        return np.where(any_pos, t.max(axis=0, initial=0.0), 0.0)
    if strategy == "var":
        var = np.zeros_like(t) if var is None else var
        w = np.where(pos, 1.0 / (var + VAR_EPS), 0.0)
        wsum = w.sum(axis=0)
        return np.divide((w * t).sum(axis=0), wsum, out=np.zeros(V),
                         where=wsum > 0)
    if strategy == "cluster":
        out = np.zeros(V)
        for v in np.nonzero(any_pos)[0]:
            s = np.sort(t[pos[:, v], v])
            if s.size == 1:
                out[v] = s[0]
            else:
                cut = int(np.argmax(np.diff(s))) + 1
                out[v] = s[cut:].mean()
        return out
    raise ValueError(strategy)


def fit_loglog(scales: Sequence[int], times: Sequence[float]
               ) -> Tuple[float, float]:
    """Least-squares fit log t = log a + b log p. Returns (a, b)."""
    xs, ys = [], []
    for p, t in zip(scales, times):
        if t > 0:
            xs.append(math.log(p))
            ys.append(math.log(t))
    if len(xs) < 2:
        return (times[-1] if times else 0.0), 0.0
    b, loga = np.polyfit(xs, ys, 1)
    return math.exp(loga), float(b)


def _fit_slopes(scales: Sequence[int], M: np.ndarray,
                valid: np.ndarray) -> np.ndarray:
    """Batched least-squares slope of log t vs log p per column.

    M is (S, V) merged times, valid the (S, V) mask of usable points;
    columns with < 2 valid points get slope 0.0 (matching ``fit_loglog``).
    """
    S, V = M.shape
    x = np.log(np.asarray(scales, float))[:, None]          # (S, 1)
    Y = np.where(valid, np.log(np.where(valid, M, 1.0)), 0.0)
    n = valid.sum(axis=0)
    Sx = (x * valid).sum(axis=0)
    Sy = Y.sum(axis=0)
    Sxx = (x * x * valid).sum(axis=0)
    Sxy = (x * Y).sum(axis=0)
    denom = n * Sxx - Sx ** 2
    num = n * Sxy - Sx * Sy
    slope = np.divide(num, denom, out=np.zeros(V), where=denom != 0)
    return np.where(n >= 2, slope, 0.0)


def fit_slopes(scales: Sequence[int], M: np.ndarray,
               valid: np.ndarray) -> np.ndarray:
    """Public batched slope fit: (S, V) merged times -> (V,) log-log
    slopes (the numpy fit the JAX package's cross-run diff reuses)."""
    return _fit_slopes(scales, np.asarray(M, float), np.asarray(valid, bool))


def detect_non_scalable(series: Mapping[int, PPG], *,
                        ideal_slope: float = -1.0,
                        slope_margin: float = 0.35,
                        min_share: float = 0.02,
                        top_k: int = 10,
                        strategy: str = "mean",
                        backend: Optional[str] = None,
                        device=None,
                        proc_mask: Optional[np.ndarray] = None
                        ) -> List[NonScalable]:
    """series: {n_procs: PPG}. Flags vertices whose scaling slope deviates
    from ideal by > slope_margin and whose time share is significant.

    ``backend``: "numpy" (host), "torch" (the fused op on ``device``), or
    None/"auto" (see :func:`_resolve_backend`).  Strategies outside
    ``JIT_STRATEGIES`` run on numpy regardless.  On the torch backend, a
    series whose reference (largest) scale is backed by a
    :class:`~repro_torch.core.shard.ShardedStore` is fed from
    device-resident shard buffers (each PPG's cached
    ``device_view(device)``; only dirty rows re-upload) — the stacked host
    matrix is never materialized.

    ``proc_mask``: optional (n_procs,) bool over the REFERENCE (largest)
    scale's processes; False rows (dead/stale hosts) are excluded from
    the merge exactly as if the reference store never contained them
    (see :func:`_norm_mask`).  A masked sharded reference falls back to
    the stacked host path."""
    scales = sorted(series)
    if not scales:
        return []
    ref = series[scales[-1]]
    psg = ref.psg
    V = len(psg.vertices)
    top = psg.children(psg.root)
    live_idx = _norm_mask(proc_mask, ref.n_procs)
    if live_idx is not None and live_idx.size == 0:
        return []

    S = len(scales)
    present = np.zeros((S, V), bool)         # vertex exists at that scale
    device_ok = isinstance(ref.perf, ShardedStore) and live_idx is None
    jx, dev = (_resolve_backend(backend, device)
               if strategy in JIT_STRATEGIES else (None, None))
    if jx is not None and device_ok:
        # device-fed: each scale's per-host blocks feed the kernels from
        # its cached TorchShardView (dirty rows re-upload, nothing
        # else); neither the stacked (S, Pmax, V) tensor nor the sharded
        # reference's (P, V) matrix is ever assembled on the host, and
        # the total step time reduces blockwise on the device
        for si, p in enumerate(scales):
            vp = min(len(series[p].psg.vertices), V)
            if vp:
                present[si, :vp] = True
        views = [series[p].device_view(dev) for p in scales]
        M, slope, share, flagged = jx.non_scalable_views(
            scales, views, V, present, top, ideal_slope, slope_margin,
            min_share, strategy)
    else:
        t_ref = ref.times_matrix()
        if live_idx is not None:
            t_ref = t_ref[live_idx]          # exact row-subset, not zeroed
        # share guards against total_max <= 0 (an all-dead final scale)
        # in every backend: share is 0 there, flagging nothing, instead
        # of the inf/nan garbage an unguarded divide produced
        total_max = float(np.sum(t_ref[:, top].max(axis=0, initial=0.0))) \
            if top else 0.0                   # initial: safe at n_procs == 0
        if jx is not None:
            # stacked (S, Pmax, V) layout: scales with fewer processes are
            # padded with dead (0.0) readings, which every merge ignores
            sizes = [series[p].n_procs for p in scales]
            sizes[-1] = t_ref.shape[0]
            p_max = max(sizes)
            T = np.zeros((S, p_max, V))
            VAR = np.zeros((S, p_max, V))
            for si, p in enumerate(scales):
                ppg = series[p]
                vp = min(len(ppg.psg.vertices), V)
                if vp:
                    tm = t_ref if si == S - 1 else ppg.times_matrix()
                    vm = ppg.var_matrix()
                    if si == S - 1 and live_idx is not None:
                        vm = vm[live_idx]
                    T[si, :tm.shape[0], :vp] = tm[:, :vp]
                    VAR[si, :vm.shape[0], :vp] = vm[:, :vp]
                    present[si, :vp] = True
            M, slope, share, flagged = jx.non_scalable_arrays(
                scales, T, VAR, present, total_max, ideal_slope,
                slope_margin, min_share, strategy, device=dev)
        else:
            M = np.zeros((S, V))             # merged time per (scale, vertex)
            for si, p in enumerate(scales):
                ppg = series[p]
                vp = min(len(ppg.psg.vertices), V)
                if vp:
                    tm = t_ref if si == S - 1 else ppg.times_matrix()
                    var = None
                    if strategy == "var":
                        var = ppg.var_matrix()
                        if si == S - 1 and live_idx is not None:
                            var = var[live_idx]
                        var = var[:, :vp]
                    M[si, :vp] = _merge_matrix(tm[:, :vp],
                                               strategy, var=var)
                    present[si, :vp] = True
            slope = _fit_slopes(scales, M, (M > 0.0) & present)
            share = np.divide(M[-1], total_max, out=np.zeros(V),
                              where=total_max > 0)
            flagged = (M.sum(axis=0) > 0.0) \
                & (slope - ideal_slope > slope_margin) & (share >= min_share)

    deviation = slope - ideal_slope
    out: List[NonScalable] = []
    for vid in np.nonzero(flagged)[0]:
        v = psg.vertices[vid]
        merged = {scales[si]: float(M[si, vid])
                  for si in range(S) if present[si, vid]}
        out.append(NonScalable(
            vid=int(vid), slope=float(slope[vid]), share=float(share[vid]),
            score=float(deviation[vid] * share[vid]), times=merged,
            kind=v.kind, name=v.name, source=v.source))
    out.sort(key=lambda d: -d.score)
    return out[:top_k]


def detect_abnormal(ppg: PPG, *, abnorm_thd: float = 1.3,
                    min_share: float = 0.01,
                    top_k: int = 20,
                    backend: Optional[str] = None,
                    device=None,
                    proc_mask: Optional[np.ndarray] = None) -> List[Abnormal]:
    """Per-process outliers at one scale (AbnormThd x cross-process median).

    ``backend`` / ``device`` as in :func:`detect_non_scalable`.  On the
    torch backend, a
    :class:`~repro_torch.core.shard.ShardedStore`-backed PPG runs entirely from
    device-resident shard buffers (incremental dirty-row upload; median,
    flags, and top-k device-side) — the online-detection fast path.

    ``proc_mask``: optional (n_procs,) bool of LIVE processes (the
    monitor's degraded-fleet contract).  False rows are excluded from the
    step time, the median and the flagging by exact row-subsetting (see
    :func:`_norm_mask`); reported ``proc`` indices stay global.  On the
    device path the live rows are gathered on the device."""
    psg = ppg.psg
    if not len(psg.vertices) or not ppg.n_procs:
        return []
    live_idx = _norm_mask(proc_mask, ppg.n_procs)
    if live_idx is not None and live_idx.size == 0:
        return []
    top = psg.children(psg.root)

    # both backends produce the same <= top_k (vid, proc) winners, ranked
    # by descending time-over-typical with stable vid-major ties, and only
    # those materialize Python objects (a straggler can flag thousands of
    # (proc, vertex) pairs; building objects for all of them dominated
    # detection cost at 8k procs)
    device_ok = isinstance(ppg.perf, ShardedStore)
    jx, dev = _resolve_backend(backend, device)
    if jx is not None and device_ok:
        # device-fed: the per-host blocks live on the device (dirty rows
        # re-upload per call), concatenate there, and the step time,
        # median, flagging and ranking all run device-side — the stacked
        # (P, V) host matrix is never materialized
        vids, procs, typical, _ = jx.abnormal_topk_view(
            ppg.device_view(dev), len(psg.vertices), top, abnorm_thd,
            min_share, top_k, live_rows=live_idx)
        picks = list(zip(vids.tolist(), procs.tolist()))
    else:
        t = ppg.times_matrix()                         # (P, V)
        if live_idx is not None:
            t = t[live_idx]                  # exact row-subset, not zeroed
        step_time = float(t[:, top].sum(axis=1).max()) if top else 0.0
        step_time = step_time or 1e-12
        if jx is not None:
            # fused flags + device-side top-k: the (P, V) flag matrix and
            # the ranking scores never round-trip to the host — only the
            # winning indices transfer
            vids, procs, typical, _ = jx.abnormal_topk(
                t, abnorm_thd, min_share, step_time, top_k, device=dev)
            picks = list(zip(vids.tolist(), procs.tolist()))
        else:
            typical = np.median(t, axis=0)             # (V,)
            active = t.max(axis=0) > 0.0
            over = (typical > 0.0) & (t > abnorm_thd * typical) \
                & ((t - typical) / step_time >= min_share)
            dead_typical = (typical == 0.0) & (t / step_time >= min_share)
            flags = (over | dead_typical) & active
            idx = np.argwhere(flags.T)                 # vid-major
            picks = []
            if idx.size:
                score = t[idx[:, 1], idx[:, 0]] - typical[idx[:, 0]]
                picks = [(int(idx[j, 0]), int(idx[j, 1]))
                         for j in np.argsort(-score, kind="stable")[:top_k]]

    out: List[Abnormal] = []
    for vid, proc in picks:
        if live_idx is not None:             # local (live-subset) -> global
            proc = int(live_idx[proc])
        v = psg.vertices[vid]
        tv, ty = float(ppg.get_time(proc, vid)), float(typical[vid])
        out.append(Abnormal(
            vid=vid, proc=proc, time=tv, typical=ty,
            ratio=tv / ty if ty > 0 else float("inf"),
            kind=v.kind, name=v.name, source=v.source))
    return out

"""Torch detection entry points — the on-device half of ``detect``.

The twin of the JAX package's ``detect_jax`` entry points that
:mod:`repro_torch.core.detect` calls on ``backend="torch"``:

* :func:`non_scalable_arrays` / :func:`abnormal_topk` — host-stacked
  inputs (an unsharded ``PerfStore``: the scenario bank, the example);
* :func:`abnormal_topk_view` / :func:`non_scalable_views` — inputs fed
  from :class:`~repro_torch.core.shard.TorchShardView`\\ s (a
  ``ShardedStore``-backed PPG: the online path), where only dirty rows
  upload per call and completed scales' merged columns stay cached on
  the device;
* :func:`fit_slopes` — the batched log-log slope fit the cross-run diff
  (:mod:`repro_torch.runs.diff`) runs per recorded run, as plain torch
  ops on the device (the JAX twin is jitted ``jnp``, not a kernel).

Every detection entry point runs ONE fused op per detector
(:mod:`repro_torch.kernels.detect_fused.ops`): the hand-written CUDA
kernels for tensors on a card, their plain torch versions on the CPU.
Only (V,)-sized results and the <= k winners come back to the host.

Precision is float64 by default and float32 when ``SCALANA_DETECT_F32``
is set (checked per call, so tests can toggle it).

The JAX package's unfused legacy chain is here too, as plain torch ops
on the views' device (it is jitted ``jnp`` there, not a kernel): the
view entry points take ``fused=False`` (a per-scale merge, then the
slope/flag tail; a sort median, flags and a stable top-k), and
:func:`merge_matrix` / :func:`abnormal_arrays` are the parity entry
points over one host matrix.  They share the fused ops' formulas
(:mod:`repro_torch.kernels.detect_fused.ref`) and launch no kernel: the
fused launch counters do not move.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.detect import JIT_STRATEGIES
from repro_torch.core.shard import TorchShardView
from repro_torch.kernels.detect_fused import ops, ref


def _precision() -> Tuple[torch.dtype, np.dtype]:
    """(torch dtype, numpy dtype) of the detection math: float64, or
    float32 when ``SCALANA_DETECT_F32`` is set (truthy)."""
    if os.environ.get("SCALANA_DETECT_F32", "").lower() in (
            "1", "true", "on", "yes"):
        return torch.float32, np.dtype(np.float32)
    return torch.float64, np.dtype(np.float64)


def _put(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def _idx(top: Sequence[int], device) -> torch.Tensor:
    return _put(np.asarray(top, np.int32).reshape(-1), np.int32, device)


def _host(*xs: torch.Tensor):
    return tuple(x.cpu().numpy() for x in xs)


def merge_matrix(t: np.ndarray, strategy: str,
                 var: Optional[np.ndarray] = None, device=None
                 ) -> np.ndarray:
    """Columnwise merge over one (n_procs, V) matrix on ``device`` ->
    (V,) host.  All strategies are computed in one stacked pass;
    ``strategy`` only selects the output row.  The parity entry point;
    detection uses the fused ops."""
    si = JIT_STRATEGIES.index(strategy)
    _, ndt = _precision()
    dev = TorchShardView.resolve_device(device)
    td = _put(np.asarray(t, ndt)[None], ndt, dev)
    vd = (torch.zeros_like(td) if var is None
          else _put(np.asarray(var, ndt)[None], ndt, dev))
    return _host(ref.merge_all_stack(td, vd)[si, 0])[0]


def abnormal_arrays(t: np.ndarray, abnorm_thd: float, min_share: float,
                    step_time: float, device=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The (P, V) abnormal-flag matrix and the (V,) typical (numpy's
    median on the host), flags on ``device``.  Materialises the whole
    flag matrix on the host: the parity entry point; detection keeps
    the flags on the device (:func:`abnormal_topk`)."""
    _, ndt = _precision()
    dev = TorchShardView.resolve_device(device)
    t_host = np.asarray(t, ndt)
    typical = np.median(t_host, axis=0)
    flags = ref.abnormal_flags(_put(t_host, ndt, dev),
                               _put(typical, ndt, dev), float(abnorm_thd),
                               float(min_share), float(step_time))
    return flags.cpu().numpy(), typical


# -- the unfused legacy chain ---------------------------------------------

def _median_flags_topk(t, valid, abnorm_thd, min_share, step_time, k):
    """Median + flags + a stable top-k over a (P, V) matrix: the
    reference's ``_median_flags_topk`` (``valid`` None: every row live)
    and its degraded-fleet variant (dead rows sort to ``+inf``, the
    middle pair indexes live rows only, dead rows are zeroed and
    unflagged).  Returns (order, scores, count, typical)."""
    if valid is None:
        srt = torch.sort(t, dim=0).values
        P = t.shape[0]
        typical = 0.5 * (srt[(P - 1) // 2] + srt[P // 2])
        tm = t
    else:
        vcol = valid[:, None]
        n_live = valid.sum().clamp(min=1)
        srt = torch.sort(torch.where(vcol, t, float("inf")), dim=0).values
        typical = 0.5 * (srt.index_select(0, ((n_live - 1) // 2).view(1))[0]
                         + srt.index_select(0, (n_live // 2).view(1))[0])
        tm = torch.where(vcol, t, 0.0)
    flags = ref.abnormal_flags(tm, typical, abnorm_thd, min_share, step_time)
    if valid is not None:
        flags = flags & valid[:, None]
    score = torch.where(flags, tm - typical, float("-inf"))
    flat = score.T.reshape(-1)                         # vid-major
    order = torch.sort(-flat, stable=True).indices[:k]
    return order, flat[order], flags.sum(), typical


def _abnormal_legacy(blocks, top, live, valid, abnorm_thd, min_share, k):
    """The legacy abnormal chain over a view's device blocks: concatenate,
    gather the live rows (padded), step time, median, flags, top-k."""
    t = torch.cat(tuple(blocks), dim=0)
    if live is not None:
        t = t[live]
    rows = t[:, top].sum(dim=1)
    if valid is not None:
        rows = torch.where(valid, rows, 0.0)
    step = rows.max()
    step = torch.where(step > 0.0, step, ref.STEP_EPS)
    return _median_flags_topk(t, valid, abnorm_thd, min_share, step, k)


def non_scalable_arrays(scales: Sequence[int], t: np.ndarray, var: np.ndarray,
                        present: np.ndarray, total_max: float,
                        ideal_slope: float, slope_margin: float,
                        min_share: float, strategy: str, device=None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Run the one-launch fused non-scalable op on ``device``; returns
    the ``strategy`` row of (M (S, V), slope (V,), share (V,), flagged
    (V,)) as host arrays."""
    si = JIT_STRATEGIES.index(strategy)
    _, ndt = _precision()
    dev = TorchShardView.resolve_device(device)
    M, slope, share, flagged = ops.fused_non_scalable(
        _put(t, ndt, dev), _put(var, ndt, dev),
        _put(np.log(np.asarray(scales, ndt)), ndt, dev),
        _put(present, bool, dev), ideal_slope=float(ideal_slope),
        slope_margin=float(slope_margin), min_share=float(min_share),
        total_max=float(total_max))
    return _host(M[si], slope[si], share[si], flagged[si])


def abnormal_topk(t: np.ndarray, abnorm_thd: float, min_share: float,
                  step_time: float, k: int, device=None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Device-resident abnormal detection over a host (P, V) matrix:
    only the winners come home.  The host receives the (vid, proc)
    indices of the ``<= k`` highest-scoring flagged entries (descending
    ``time - typical``, ties in vid-major enumeration order), the (V,)
    typical vector, and the total flagged count.  Returns ``(vids,
    procs, typical, n_flagged)``."""
    _, ndt = _precision()
    dev = TorchShardView.resolve_device(device)
    t_host = np.asarray(t, ndt)
    order, _, count, typical = ops.fused_abnormal(
        (_put(t_host, ndt, dev),), None, float(abnorm_thd),
        float(min_share), int(k), step_time=float(step_time))
    n_flagged = int(count)
    order, typical = _host(order[:min(int(k), n_flagged)], typical)
    n_procs = t_host.shape[0]
    return order // n_procs, order % n_procs, typical, n_flagged


def abnormal_topk_view(view: TorchShardView, n_vertices: int,
                       top: Sequence[int], abnorm_thd: float,
                       min_share: float, k: int,
                       live_rows: Optional[np.ndarray] = None,
                       fused: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Abnormal detection fed straight from a
    :class:`~repro_torch.core.shard.TorchShardView` — the online entry
    point.

    ``view.refresh`` uploads only the rows written since the last call;
    the per-host blocks then concatenate on the device, where the step
    time (over ``top``, the root's child vids), median, flagging and
    top-k ranking all run.  Returns ``(vids, procs, typical,
    n_flagged)`` like :func:`abnormal_topk`.

    ``live_rows``: optional live global row indices (degraded fleets).
    The gather runs on the device at a shape PADDED to the fleet size
    (pad rows repeat row 0 and are masked out by ``valid``), so the
    launch shapes depend on the fleet size alone.  The returned
    ``procs`` index INTO ``live_rows`` (the caller maps back to global
    procs), matching the host path's row-subset semantics.

    ``fused=True`` (the default) runs the one-launch fused op;
    ``fused=False`` the legacy unfused chain as plain torch ops (the
    baseline the parity tests pin the fused path against)."""
    _, ndt = _precision()
    n_procs = view.n_procs
    view.refresh(n_vertices, ndt)
    dev = view.device
    live = valid = None
    if live_rows is not None:
        pad = np.zeros(n_procs, np.int64)
        mask = np.zeros(n_procs, bool)
        n_live = int(len(live_rows))
        pad[:n_live] = np.asarray(live_rows, np.int64)
        mask[:n_live] = True
        live, valid = _put(pad, np.int64, dev), _put(mask, bool, dev)
    if fused:
        view.kernel_launches += 1
        order, _, count, typical = ops.fused_abnormal(
            view.time_blocks(), _idx(top, dev), float(abnorm_thd),
            float(min_share), int(k), live=live, valid=valid)
    else:
        order, _, count, typical = _abnormal_legacy(
            view.time_blocks(), _idx(top, dev).long(), live, valid,
            float(abnorm_thd), float(min_share), int(k))
    n_flagged = int(count)
    order, typical = _host(order[:min(int(k), n_flagged)], typical)
    return order // n_procs, order % n_procs, typical, n_flagged


def non_scalable_views(scales: Sequence[int], views: Sequence[TorchShardView],
                       n_vertices: int, present: np.ndarray,
                       top: Sequence[int], ideal_slope: float,
                       slope_margin: float, min_share: float, strategy: str,
                       fused: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Non-scalable detection fed from per-scale
    :class:`~repro_torch.core.shard.TorchShardView`\\ s.

    Historical scales are IMMUTABLE once their run completes: each
    completed view's (4, V) merged column is computed once
    (``merge_scale_column``) and cached on the view keyed by its upload
    revision (:meth:`~repro_torch.core.shard.TorchShardView.
    merged_column`), so a steady-state call merges only the LIVE scale's
    blocks and runs the slope/share/flag tail — one
    ``fused_non_scalable_live`` launch over the cached (4, S-1, V) stack.
    Any write, re-pin, layout or dtype change bumps the revision and
    refills that scale's column.  The reference step time derives from
    the merged "max" row at the final scale.  ``fused=False`` keeps the
    legacy per-scale merge + slope/flag chain as plain torch ops (no
    cache, no kernel).  Returns the ``strategy`` row of (M (S, V), slope
    (V,), share (V,), flagged (V,)) as host arrays — O(S·V), never
    O(P·V)."""
    si = JIT_STRATEGIES.index(strategy)
    tdt, ndt = _precision()
    for view in views:
        view.refresh(n_vertices, ndt)
    if not fused:
        dev = views[-1].device
        M = torch.stack([ref.merge_blocks(v.time_blocks(), v.var_blocks())
                         for v in views], dim=1)           # (4, S, V)
        total_max = M[ref.IMAX, -1, _idx(top, dev).long()].sum()
        slope, share, flagged = ref.slope_share_flag(
            M, _put(np.log(np.asarray(scales, ndt)), ndt, dev),
            _put(present, bool, dev), total_max, float(ideal_slope),
            float(slope_margin), float(min_share))
        return _host(M[si], slope[si], share[si], flagged[si])
    cols = []
    for v in views[:-1]:
        col = v.merged_column()
        if col is None:
            col = ops.merge_scale_column(v.time_blocks(), v.var_blocks())
            v.cache_merged_column(col)
            v.kernel_launches += 1
        cols.append(col)
    live = views[-1]
    dev = live.device
    hist = (torch.stack(cols, dim=1) if cols
            else torch.zeros((4, 0, int(n_vertices)), dtype=tdt, device=dev))
    live.kernel_launches += 1
    M, slope, share, flagged = ops.fused_non_scalable_live(
        live.time_blocks(), live.var_blocks(), hist,
        _put(np.log(np.asarray(scales, ndt)), ndt, dev),
        _put(present, bool, dev), _idx(top, dev),
        ideal_slope=float(ideal_slope), slope_margin=float(slope_margin),
        min_share=float(min_share))
    return _host(M[si], slope[si], share[si], flagged[si])


def fit_slopes(scales: Sequence[int], M: np.ndarray, valid: np.ndarray,
               device=None) -> np.ndarray:
    """Batched least-squares slope of log t vs log p per column, on
    ``device``: (S, V) merged times -> (V,) host slopes.

    The torch twin of ``detect.fit_slopes`` (same formulas, same clamp to
    0.0 for columns with fewer than 2 valid points or a zero
    denominator), in the precision of :func:`_precision`.  ``valid`` is
    the (S, V) mask of usable points."""
    tdt, ndt = _precision()
    dev = TorchShardView.resolve_device(device)
    x = _put(np.log(np.asarray(scales, ndt)), ndt, dev)[:, None]  # (S, 1)
    m = _put(M, ndt, dev)
    ok = _put(valid, bool, dev)
    Y = torch.where(ok, torch.log(torch.where(ok, m, 1.0)), 0.0)
    w = ok.to(tdt)
    n = w.sum(0)
    Sx = (x * w).sum(0)
    Sy = Y.sum(0)
    Sxx = (x * x * w).sum(0)
    Sxy = (x * Y).sum(0)
    denom = n * Sxx - Sx ** 2
    num = n * Sxy - Sx * Sy
    nonzero = denom != 0
    slope = torch.where(nonzero, num / torch.where(nonzero, denom, 1.0), 0.0)
    return torch.where(n >= 2, slope, 0.0).cpu().numpy()

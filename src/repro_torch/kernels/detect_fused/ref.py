"""Plain PyTorch versions of the fused detection kernels.

The same functions as the CUDA kernels in :mod:`.kernel`, written as
ordinary tensor code: the ops run them for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.  They
follow the JAX package's shared formulas (its ``detect_fused/kernel.py``
merge / slope / flag block and ``ref.py``), with two orders fixed so the
kernels can match them bit for bit where the contract says exact:

* the step time sums a row's root-child columns one by one, in the
  order of ``top_idx``, starting from 0 (the kernel does the same);
* the median is the mean of the two middle order statistics, read from
  ``torch.sort`` over order-preserving integer keys (dead rows take the
  ``+inf`` key), and the top-k is a stable sort of the negated vid-major
  flat scores — descending score, ties by ascending ``vid * P + proc``,
  unflagged entries scoring ``-inf`` after every flagged one.

Scalar parameters become 0-d tensors of the working dtype before any
arithmetic, so float32 runs round them exactly as the kernels do.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.detect import JIT_STRATEGIES, VAR_EPS

IMAX = JIT_STRATEGIES.index("max")
STEP_EPS = 1e-12          # step-time clamp, matches the host reference


# -- float <-> order-preserving integer keys ---------------------------

def key_info(dtype: torch.dtype) -> Tuple[torch.dtype, int]:
    """Signed key dtype + bit width for a float dtype (torch sorts
    signed integers everywhere; unsigned 64-bit sorting is not there)."""
    if dtype == torch.float64:
        return torch.int64, 64
    if dtype == torch.float32:
        return torch.int32, 32
    raise TypeError(f"unsupported detect dtype {dtype}")


def to_key(x: torch.Tensor) -> torch.Tensor:
    """Bitcast floats to signed integer keys whose order is the float
    total order (-inf < ... < +inf).  A negative float keeps its sign
    bit and flips the rest, so larger magnitudes sort lower.  This is
    the CUDA kernels' unsigned key with its top bit flipped."""
    kd, bits = key_info(x.dtype)
    b = x.contiguous().view(kd)
    return torch.where(b < 0, b ^ ((1 << (bits - 1)) - 1), b)


def from_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_key`."""
    _, bits = key_info(dtype)
    b = torch.where(k < 0, k ^ ((1 << (bits - 1)) - 1), k)
    return b.contiguous().view(dtype)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _top_list(top_idx: Optional[torch.Tensor]) -> list:
    return [] if top_idx is None else top_idx.tolist()


# -- non-scalable -------------------------------------------------------

def merge_all_stack(t: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """(S, P, V) times + variances -> (4, S, V) merged, rows ordered as
    JIT_STRATEGIES.  Non-positive readings are dead (excluded)."""
    pos = t > 0.0
    cnt = pos.sum(dim=1)                               # (S, V)
    any_pos = cnt > 0
    total = torch.where(pos, t, 0.0).sum(dim=1)
    mean = torch.where(any_pos, total / cnt.clamp(min=1).to(t.dtype), 0.0)
    mx = torch.where(any_pos, t.amax(dim=1), 0.0)
    p0 = t[:, 0, :]
    p0 = torch.where(p0 > 0.0, p0, mean)
    w = torch.where(pos, 1.0 / (var + VAR_EPS), 0.0)
    wsum = w.sum(dim=1)
    varm = torch.where(wsum > 0,
                       (w * t).sum(dim=1) / torch.where(wsum > 0, wsum, 1.0),
                       0.0)
    return torch.stack([mean, mx, p0, varm])           # (4, S, V)


def merge_blocks(ts: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One scale's (n_local, V) blocks, in global proc order -> its
    (4, V) merged column."""
    t = torch.cat(tuple(ts), dim=0)
    v = torch.cat(tuple(vs), dim=0)
    return merge_all_stack(t[None], v[None])[:, 0]


def total_from_top(M: torch.Tensor, top_idx) -> torch.Tensor:
    """Reference step time: the "max" row at the last scale, summed over
    the root-child columns in ``top_idx`` order."""
    total = torch.zeros((), dtype=M.dtype, device=M.device)
    for j in _top_list(top_idx):
        total = total + M[IMAX, -1, j]
    return total


def slope_share_flag(M, logp, present, total_max,
                     ideal_slope, slope_margin, min_share):
    """(4, S, V) merged stack -> (slope, share, flagged), each (4, V).

    ``share`` is guarded: an all-dead final scale (``total_max <= 0``)
    yields share 0 — and so flags nothing — instead of inf/nan."""
    total_max = _scalar(total_max, M)
    valid = (M > 0.0) & present[None].bool()
    x = logp.to(M.dtype)[None, :, None]                # (1, S, 1)
    Y = torch.where(valid, torch.log(torch.where(valid, M, 1.0)), 0.0)
    n = valid.sum(dim=1)                               # (4, V)
    Sx = (x * valid).sum(dim=1)
    Sy = Y.sum(dim=1)
    Sxx = (x * x * valid).sum(dim=1)
    Sxy = (x * Y).sum(dim=1)
    nf = n.to(M.dtype)
    denom = nf * Sxx - Sx * Sx
    num = nf * Sxy - Sx * Sy
    slope = torch.where((denom != 0) & (n >= 2),
                        num / torch.where(denom != 0, denom, 1.0), 0.0)
    share = torch.where(total_max > 0.0,
                        M[:, -1, :] / torch.where(total_max > 0.0,
                                                  total_max, 1.0), 0.0)
    flagged = ((M.sum(dim=1) > 0.0)
               & (slope - _scalar(ideal_slope, M) > _scalar(slope_margin, M))
               & (share >= _scalar(min_share, M)))
    return slope, share, flagged


def non_scalable(t: torch.Tensor, var: torch.Tensor, hist: torch.Tensor,
                 logp: torch.Tensor, present: torch.Tensor, top_idx, *,
                 ideal_slope: float, slope_margin: float, min_share: float,
                 total_max: Optional[float] = None):
    """The whole ns kernel: merge the (S_d, P, V) data scales, prepend
    the (4, H, V) historical columns, take the reference step time
    (``total_max`` when given, else from the "max" row over
    ``top_idx``), fit and flag.  Returns (M (4, H + S_d, V), slope,
    share, flagged bool)."""
    M = merge_all_stack(t, var)
    if hist.shape[1]:
        M = torch.cat([hist.to(M.dtype), M], dim=1)
    total = total_from_top(M, top_idx) if total_max is None else total_max
    slope, share, flagged = slope_share_flag(
        M, logp, present, total, ideal_slope, slope_margin, min_share)
    return M, slope, share, flagged


# -- abnormal -----------------------------------------------------------

def abnormal_flags(t, typical, abnorm_thd, min_share, step_time):
    """(P, V) times + (V,) typical -> (P, V) abnormal-entry mask."""
    thd, share = _scalar(abnorm_thd, t), _scalar(min_share, t)
    step = _scalar(step_time, t)
    active = t.amax(dim=0) > 0.0
    over = ((t > thd * typical) & (typical > 0.0)
            & ((t - typical) / step >= share))
    dead_typical = (typical == 0.0) & (t / step >= share)
    return (over | dead_typical) & active


def abnormal(t: torch.Tensor, valid: Optional[torch.Tensor], top_idx,
             abnorm_thd: float, min_share: float, k: int,
             step_time: Optional[float] = None):
    """The whole ab kernel over a (P, V) time matrix (already
    live-gathered and padded on the degraded path; ``valid`` marks the
    real rows, None = all live).  Returns (order (k,) int32 flat
    vid-major, scores (k,), count () int32, typical (V,))."""
    P, V = t.shape
    dt = t.dtype
    if valid is None:
        valid = torch.ones(P, dtype=torch.bool, device=t.device)
    valid = valid.bool()
    vcol = valid[:, None]
    tm = torch.where(vcol, t, 0.0)
    if step_time is None:
        acc = torch.zeros(P, dtype=dt, device=t.device)
        for j in _top_list(top_idx):
            acc = acc + t[:, j]
        sv = torch.where(valid, acc, 0.0).max()
        step = torch.where(sv > 0.0, sv, _scalar(STEP_EPS, t))
    else:
        step = _scalar(step_time, t)
    n_live = valid.sum().clamp(min=1)
    keys = to_key(torch.where(vcol, t, float("inf")))
    srt = torch.sort(keys, dim=0).values
    lo = from_key(srt.index_select(0, ((n_live - 1) // 2).view(1))[0], dt)
    hi = from_key(srt.index_select(0, (n_live // 2).view(1))[0], dt)
    typical = 0.5 * (lo + hi)
    flags = abnormal_flags(tm, typical, abnorm_thd, min_share, step) & vcol
    score = torch.where(flags, tm - typical, float("-inf"))
    flat = score.T.reshape(-1)
    order = torch.sort(-flat, stable=True).indices[:k]
    return (order.to(torch.int32), flat[order],
            flags.sum().to(torch.int32), typical)

"""Build, binding and wrappers of the hand-written CUDA detection kernels.

Two kernels, each a CUDA C++ source under ``csrc/`` with a plain C
interface:

* ``ab_fused`` (``csrc/ab_fused.cu``) — abnormal detection over a (P, V)
  time matrix: step time, masked per-column median by radix selection
  over transposed keys, each column split across a thread-block cluster,
  flags, exact top-k.  Replaces the JAX package's Pallas
  ``ab_fused_kernel``.
* ``ns_fused`` (``csrc/ns_fused.cu``) — non-scalable detection in one
  launch: per-scale merges over rows, historical-column splice, log-log
  slope fit, share and flags.  Replaces the Pallas ``ns_fused_kernel``;
  with ``tail=False`` it is only the merge stage
  (``merge_scale_column``).  It reads up to ``NS_MAX_BLOCKS`` shard
  blocks of one scale in place.

Each source is built on first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a``, keyed by a hash of the source and the flags,
loaded with ``ctypes``).  Nothing is compiled or loaded at import time.
The wrappers check device, dtype, shape and contiguity, allocate outputs
and scratch with ``torch.empty``, launch on the current stream without
synchronising, raise when the C entry reports a CUDA error, and count
their launches in a plain integer (``ab_fused.launches``,
``ns_fused.launches``).  They take CUDA tensors
only: the plain versions for CPU tensors are in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check as _check, ptr as _ptr

CSRC = Path(__file__).resolve().parent / "csrc"
AB_ROW_TILE = 64          # rows per ab_keys block (csrc/ab_fused.cu KR)
NS_ROW_TILE = 256         # rows per ns_fused tile (csrc/ns_fused.cu TP)
NS_MAX_BLOCKS = 16        # shard blocks ns_fused reads in place (csrc NB)
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = {
    "ab_fused": [_P, _P, _P, _I, _I, _I, _D, _D, _D, _I, _I,
                 _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "ns_fused": [_P, _P, _P, _I, ctypes.c_longlong, _P, _P, _P, _P, _I,
                 _I, _I, _I, _I, _D, _D, _D, _D, _I, _I,
                 _P, _P, _P, _P, _P, _P, _P, _P],
}
# no FMA contraction: every product and sum rounds on its own, as in the
# numpy reference
LIBRARIES = {
    n: _build.Library(n, CSRC / f"{n}.cu",
                      {f"{n}_{dt}": _ARGTYPES[n] for dt in ("f64", "f32")},
                      extra_flags=("-fmad=false",))
    for n in ("ab_fused", "ns_fused")}


def _entry(name: str, dtype: torch.dtype):
    suffix = {torch.float64: "f64", torch.float32: "f32"}[dtype]
    lib = LIBRARIES[name]
    return lib, lib.entry(f"{name}_{suffix}")


def _float_dtype(t: torch.Tensor) -> torch.dtype:
    if t.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"detection kernels take float64 or float32, "
                        f"not {t.dtype}")
    return t.dtype


def _carve(dev: torch.device, sizes) -> list:
    """One byte buffer cut into 256-byte aligned pieces of ``sizes``:
    [buffer, address of each piece]."""
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    return [buf] + [buf.data_ptr() + o for o in offs]


def ab_fused(t: torch.Tensor, valid: Optional[torch.Tensor],
             top_idx: torch.Tensor, abnorm_thd: float, min_share: float,
             k: int, step_time: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Abnormal detection over a (P, V) CUDA time matrix.

    ``valid``: (P,) bool live-row mask or None (all live).  ``top_idx``:
    (n_top,) int32 step-time columns (indices outside [0, V) add
    nothing).  ``step_time`` overrides the in-kernel step time.  Returns
    (order (k,) int32 flat vid-major, scores (k,), count () int32,
    typical (V,)), ranked as :func:`.ref.abnormal` ranks."""
    dt = _float_dtype(t)
    _check("t", t, ndim=2)
    P, V = t.shape
    dev = t.device
    if P == 0 or V == 0:
        raise ValueError("ab_fused: empty time matrix")
    if P * V >= 2 ** 31:
        raise ValueError("ab_fused: P * V must fit in int32 flat indices")
    k = int(k)
    if not 1 <= k <= P * V:
        raise ValueError(f"ab_fused: k={k} outside [1, {P * V}]")
    if valid is not None:
        _check("valid", valid, dtype=torch.bool, shape=(P,), device=dev)
    _check("top_idx", top_idx, dtype=torch.int32, ndim=1, device=dev)
    lib, fn = _entry("ab_fused", dt)
    nblk = -(-P // AB_ROW_TILE)
    kc = min(k, P)                  # candidate slots per column
    esz = t.element_size()          # float and key bytes
    # one workspace: keys (V, P), step / live partials, 2V candidate lists
    # of kc keys and flat indices, per-column flag counts
    scratch = _carve(dev, [V * P * esz, nblk * esz, nblk * 4,
                           2 * V * kc * esz, 2 * V * kc * 4, V * 4])
    empty = torch.empty
    order = empty(k, dtype=torch.int32, device=dev)
    scores = empty(k, dtype=dt, device=dev)
    count = empty((), dtype=torch.int32, device=dev)
    typical = empty(V, dtype=dt, device=dev)
    use_step = step_time is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(t.data_ptr(), _ptr(valid), top_idx.data_ptr(),
                top_idx.numel(), P, V, float(abnorm_thd), float(min_share),
                float(step_time) if use_step else 0.0, int(use_step), k,
                *scratch[1:], order.data_ptr(),
                scores.data_ptr(), count.data_ptr(), typical.data_ptr(),
                stream)
    lib.raise_on(rc, "ab_fused")
    ab_fused.launches += 1
    return order, scores, count, typical


ab_fused.launches = 0


_TICKETS: dict = {}       # (device index, stream) -> ns_fused's counter


def _ticket(dev: torch.device) -> torch.Tensor:
    """ns_fused's ticket counter on ``dev``'s current stream: zeroed once
    here, and left at zero by every launch that uses it."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def ns_fused(t, var, hist: torch.Tensor, logp: torch.Tensor,
             present: torch.Tensor, top_idx: torch.Tensor, *,
             ideal_slope: float = 0.0, slope_margin: float = 0.0,
             min_share: float = 0.0, total_max: Optional[float] = None,
             tail: bool = True):
    """Non-scalable detection over (S_d, P, V) CUDA time / variance
    stacks, with the (4, H, V) historical merged columns prepended.

    ``t`` and ``var`` are either (S_d, P, V) tensors or sequences of at
    most ``NS_MAX_BLOCKS`` (n_i, V) shard blocks of one scale in row
    order (S_d = 1), which the kernel reads in place.  ``logp``:
    (H + S_d,) log process counts; ``present``: (H + S_d, V) bool;
    ``top_idx``: (n_top,) int32 columns of the reference step time (used
    unless ``total_max`` is given).  Returns (M (4, H + S_d, V), slope,
    share, flagged bool), each (4, V) after M.  ``tail=False`` runs only
    the merge stage and returns M (4, S_d, V) (H must be 0)."""
    if isinstance(t, torch.Tensor):
        _check("t", t, ndim=3)
        S_d, P, V = t.shape
        _check("var", var, dtype=t.dtype, shape=(S_d, P, V),
               device=t.device)
        ts, vs, stride, row0 = [t], [var], P * V, [0, P]
    else:
        ts, vs = list(t), list(var)
        if not 1 <= len(ts) <= NS_MAX_BLOCKS or len(vs) != len(ts):
            raise ValueError(f"ns_fused: 1 to {NS_MAX_BLOCKS} blocks of t "
                             f"and as many of var, not {len(ts)} and "
                             f"{len(vs)}")
        _check("t[0]", ts[0], ndim=2)
        V = ts[0].shape[1]
        for i, (tb, vb) in enumerate(zip(ts, vs)):
            _check(f"t[{i}]", tb, dtype=ts[0].dtype, ndim=2,
                   device=ts[0].device)
            if tb.shape[1] != V:
                raise ValueError(f"ns_fused: block {i} has {tb.shape[1]} "
                                 f"columns, expected {V}")
            _check(f"var[{i}]", vb, dtype=tb.dtype, shape=tb.shape,
                   device=tb.device)
        row0 = [0]
        for b in ts:
            row0.append(row0[-1] + b.shape[0])
        S_d, P, stride = 1, row0[-1], 0
    dt = _float_dtype(ts[0])
    dev = ts[0].device
    if S_d == 0 or V == 0:
        raise ValueError("ns_fused: empty stack")
    if P >= 2 ** 31:
        raise ValueError("ns_fused: P must fit in int32 row indices")
    _check("hist", hist, dtype=dt, ndim=3, device=dev)
    H = hist.shape[1]
    if hist.shape[0] != 4 or hist.shape[2] != V:
        raise ValueError(f"ns_fused: hist shape {tuple(hist.shape)}, "
                         f"expected (4, H, {V})")
    S_t = H + S_d
    if tail:
        _check("logp", logp, dtype=dt, shape=(S_t,), device=dev)
        _check("present", present, dtype=torch.bool, shape=(S_t, V),
               device=dev)
        _check("top_idx", top_idx, dtype=torch.int32, ndim=1, device=dev)
    elif H:
        raise ValueError("ns_fused: the merge stage takes no hist")
    lib, fn = _entry("ns_fused", dt)
    ntiles = max(-(-P // NS_ROW_TILE), 1)
    nb = len(ts)
    empty = torch.empty
    part_cnt = empty(S_d * ntiles * V, dtype=torch.int32, device=dev)
    part_f = empty(S_d * ntiles * 4 * V, dtype=dt, device=dev)
    M = empty((4, S_t, V), dtype=dt, device=dev)
    slope = empty((4, V), dtype=dt, device=dev) if tail else None
    share = empty((4, V), dtype=dt, device=dev) if tail else None
    flag = empty((4, V), dtype=torch.bool, device=dev) if tail else None
    use_total = total_max is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn((_P * nb)(*(b.data_ptr() for b in ts)),
                (_P * nb)(*(b.data_ptr() for b in vs)),
                (_I * (nb + 1))(*row0), nb, stride, _ptr(hist),
                _ptr(logp) if tail else None,
                _ptr(present) if tail else None,
                _ptr(top_idx) if tail else None,
                top_idx.numel() if tail else 0, S_d, P, V, H,
                float(ideal_slope), float(slope_margin), float(min_share),
                float(total_max) if use_total else 0.0, int(use_total),
                int(tail), part_cnt.data_ptr(), part_f.data_ptr(),
                _ticket(dev).data_ptr(), M.data_ptr(), _ptr(slope),
                _ptr(share), _ptr(flag), stream)
    lib.raise_on(rc, "ns_fused")
    ns_fused.launches += 1
    if not tail:
        return M
    return M, slope, share, flag


ns_fused.launches = 0


def reset_launches() -> None:
    """Set both kernels' launch counts to 0."""
    ab_fused.launches = 0
    ns_fused.launches = 0

"""Public fused-detection ops: dispatch and launch counting.

Four ops cover the detection tail, each ONE logical launch:

* :func:`fused_non_scalable` — stacked (S, P, V) merge + slope + flag.
* :func:`fused_non_scalable_live` — the steady-state variant: merge only
  the LIVE scale's blocks, splice in the device-cached historical (4, H,
  V) merged columns, then slope + flag.  This is what makes incremental
  detect O(live scale), not O(all scales).
* :func:`fused_abnormal` — step time + masked median + flags + stable
  top-k over the (P, V) matrix (blockwise and degraded-fleet variants).
* :func:`merge_scale_column` — one scale's (4, V) merged column, the
  historical-column cache fill.

Dispatch is by the device of the input tensors and nothing else: CUDA
tensors go to the hand-written kernels in :mod:`.kernel`, CPU tensors to
their plain versions in :mod:`.ref`.  The CUDA kernels take any P and V
and mask their own ragged edges, so nothing is padded here; the
non-scalable kernel reads the live scale's shard blocks in place (up to
``kernel.NS_MAX_BLOCKS`` of them), so only the abnormal op concatenates.

Every op bumps ``launch_counts`` and calls the monkeypatchable
``on_launch`` hook once per logical launch, so tests and benches can
ASSERT "steady-state detect = 1 non-scalable + 1 abnormal launch"
instead of inferring it from timings.
"""
from __future__ import annotations

import collections
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.detect_fused import kernel, ref

# -- launch counting seam ----------------------------------------------
# One logical launch == one fused op call.  ``launch_counts`` accumulates
# per-op totals; ``on_launch`` (monkeypatchable) sees each launch name.
launch_counts: collections.Counter = collections.Counter()
on_launch: Optional[Callable[[str], None]] = None


def _note_launch(name: str) -> None:
    launch_counts[name] += 1
    hook = on_launch
    if hook is not None:
        hook(name)


def reset_launch_counts() -> None:
    launch_counts.clear()


def _cat(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    return blocks[0] if len(blocks) == 1 else torch.cat(tuple(blocks), 0)


def _in_place(ts: Sequence[torch.Tensor], vs: Sequence[torch.Tensor]):
    """The (t, var) blocks as ``kernel.ns_fused`` reads them in place, or
    each concatenated where there are more blocks than its table holds
    or a block is not contiguous."""
    if len(ts) <= kernel.NS_MAX_BLOCKS and all(
            b.is_contiguous() for b in (*ts, *vs)):
        return list(ts), list(vs)
    return _cat(ts)[None], _cat(vs)[None]


def _no_top(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.int32, device=like.device)


# -- public ops ---------------------------------------------------------

def fused_abnormal(ts: Sequence[torch.Tensor],
                   top_idx: Optional[torch.Tensor],
                   abnorm_thd: float, min_share: float, k: int, *,
                   step_time: Optional[float] = None,
                   live: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """One-launch abnormal detection over device time blocks.

    ``ts``: (n_local, V) blocks in global proc order (a single block for
    the host-stacked path).  ``top_idx``: int32 step-time column indices
    (unused when ``step_time`` is given).  ``live`` / ``valid``: padded
    live-row gather indices + real-row mask for degraded fleets (fixed
    shapes: the gather is padded to the fleet size, whatever the live
    count).  Returns ``(order, scores, count, typical)`` tensors: flat
    vid-major indices and scores of the top ``k`` entries (descending
    ``time - typical``, stable ascending-index ties, -inf tail), the
    total flagged count, and the (V,) typical vector."""
    ts = tuple(ts)
    V = ts[0].shape[1]
    P = live.shape[0] if live is not None else sum(b.shape[0] for b in ts)
    dtype, dev = ts[0].dtype, ts[0].device
    k_eff = max(min(int(k), P * V), 0)
    if k_eff == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=dtype, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros(V, dtype=dtype, device=dev))
    _note_launch("abnormal")
    t = _cat(ts)
    if live is not None:
        t = t.index_select(0, live)
    top = top_idx if top_idx is not None else _no_top(t)
    if t.is_cuda:
        return kernel.ab_fused(t, valid, top, abnorm_thd, min_share, k_eff,
                               step_time=step_time)
    return ref.abnormal(t, valid, top, abnorm_thd, min_share, k_eff,
                        step_time=step_time)


def fused_non_scalable(t: torch.Tensor, var: torch.Tensor,
                       logp: torch.Tensor, present: torch.Tensor, *,
                       ideal_slope: float, slope_margin: float,
                       min_share: float,
                       total_max: Optional[float] = None,
                       top_idx: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """One-launch non-scalable detection over the stacked (S, P, V)
    time/variance tensors.  ``total_max`` (host-derived reference step
    time) wins over the in-kernel derivation from ``top_idx``.  Returns
    (M (4, S, V), slope (4, V), share (4, V), flagged (4, V) bool)."""
    _note_launch("non_scalable")
    top = top_idx if top_idx is not None else _no_top(t)
    hist = torch.zeros((4, 0, t.shape[2]), dtype=t.dtype, device=t.device)
    kw = dict(ideal_slope=ideal_slope, slope_margin=slope_margin,
              min_share=min_share, total_max=total_max)
    if t.is_cuda:
        return kernel.ns_fused(t, var, hist, logp, present, top, **kw)
    return ref.non_scalable(t, var, hist, logp, present, top, **kw)


def fused_non_scalable_live(ts: Sequence[torch.Tensor],
                            vs: Sequence[torch.Tensor], hist: torch.Tensor,
                            logp: torch.Tensor, present: torch.Tensor,
                            top_idx: torch.Tensor, *, ideal_slope: float,
                            slope_margin: float, min_share: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """Steady-state non-scalable detection: merge only the LIVE scale's
    (n_local, V) blocks, append the merged column to the device-cached
    historical (4, H, V) stack, and run the slope/share/flag tail — all
    one launch.  ``logp`` / ``present`` cover all H + 1 scales (live
    last).  Returns (M (4, H + 1, V), slope, share, flagged bool)."""
    _note_launch("non_scalable_live")
    kw = dict(ideal_slope=ideal_slope, slope_margin=slope_margin,
              min_share=min_share)
    if ts[0].is_cuda:
        t, v = _in_place(ts, vs)
        return kernel.ns_fused(t, v, hist, logp, present, top_idx, **kw)
    return ref.non_scalable(_cat(ts)[None], _cat(vs)[None], hist, logp,
                            present, top_idx, **kw)


def merge_scale_column(ts: Sequence[torch.Tensor],
                       vs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One scale's blocks -> its (4, V) merged column (one launch).

    The cache-fill op: historical scales run through this once, then
    their columns stay device-resident until the underlying blocks
    change (see ``TorchShardView.merged_column``)."""
    _note_launch("merge_column")
    if ts[0].is_cuda:
        hist = torch.zeros((4, 0, ts[0].shape[1]), dtype=ts[0].dtype,
                           device=ts[0].device)
        t, v = _in_place(ts, vs)
        return kernel.ns_fused(t, v, hist, None, None, None,
                               tail=False)[:, 0]
    return ref.merge_blocks(ts, vs)

"""Cross-run regression diff: per-vertex scaling-curve deltas + flags.

``diff_runs(base, cand)`` aligns the two runs' PSGs
(:func:`repro_torch.runs.align.align_psgs`), then compares each matched
vertex's scaling curve:

* **ratio** — candidate vs base merged time at the comparison scale
  (the largest scale both runs recorded; falls back to each run's own
  top scale when their scale sets are disjoint, e.g. a run recorded at
  a different proc count);
* **slope delta** — candidate minus base log-log scaling slope, fitted
  with the SAME batched least-squares machinery detection uses
  (``detect.fit_slopes``; the torch twin ``detect_torch.fit_slopes``
  engages through ``detect._resolve_backend``, exactly like
  ``detect_non_scalable``);
* **regression flag** — time ratio above ``ratio_thd`` or slope
  degradation above ``slope_margin``, gated on a minimum share of the
  candidate step time so noise vertices cannot flood the report.

Unmatched vertices are reported as added/removed, never diffed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.detect import _merge_matrix, _resolve_backend, fit_slopes
from repro_torch.core.graph import PPG
from repro_torch.runs.align import Alignment, align_psgs
from repro_torch.runs.store import RunRecord


def scaling_curves(series: Mapping[int, PPG], *, strategy: str = "mean"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(scales (S,), M (S, V)): merged per-vertex times across a
    ``{n_procs: PPG}`` series — the curve block a run records.

    Columns are padded to the widest graph in the series; absent
    vertices merge to 0.0, which the slope fit treats as invalid."""
    scales = np.asarray(sorted(series), np.int64)
    V = max(len(series[int(s)].psg.vertices) for s in scales)
    M = np.zeros((scales.size, V))
    for i, s in enumerate(scales.tolist()):
        ppg = series[s]
        row = _merge_matrix(np.asarray(ppg.times_matrix(), float), strategy,
                            np.asarray(ppg.var_matrix(), float))
        M[i, :row.size] = row
    return scales, M


@dataclasses.dataclass
class VertexDelta:
    """One matched vertex's cross-run comparison."""
    vid_base: int
    vid_cand: int
    kind: str
    name: str
    source: str
    base_time: float             # merged time at the comparison scale
    cand_time: float
    ratio: float                 # cand / base (inf when base was 0)
    share: float                 # of the candidate run's step time
    base_slope: float            # log-log scaling slope (0 when < 2 pts)
    cand_slope: float
    slope_delta: float           # cand - base (positive = scales worse)
    base_peak: float             # slowest stored row (per-proc outlier)
    cand_peak: float
    peak_ratio: float            # cand_peak / base_peak (0 when unused)
    regressed: bool
    score: float                 # ranking key: excess time x share

    def describe(self) -> str:
        tag = f"{self.kind} {self.name}"
        if self.source:
            tag += f" @ {self.source}"
        peak = f", peak x{self.peak_ratio:.2f}" if self.peak_ratio else ""
        return (f"{tag}: {self.base_time:.3e}s -> {self.cand_time:.3e}s "
                f"(x{self.ratio:.2f}, slope {self.base_slope:+.2f} -> "
                f"{self.cand_slope:+.2f}{peak}, share {self.share:.1%})")


@dataclasses.dataclass
class RunDiff:
    """The full cross-run comparison ``diff_runs`` returns."""
    base_id: str
    cand_id: str
    alignment: Alignment
    deltas: List[VertexDelta]            # every matched vertex with data
    regressions: List[VertexDelta]       # flagged, sorted by score desc
    removed: List[str]                   # vertices only in base
    added: List[str]                     # vertices only in cand
    base_scale: int                      # comparison scales per side
    cand_scale: int
    backend: str                         # slope-fit backend used

    @property
    def regressed_vids(self) -> List[int]:
        """Candidate-side vids of the flagged regressions, best first."""
        return [d.vid_cand for d in self.regressions]

    def __repr__(self) -> str:
        return (f"RunDiff({self.base_id} -> {self.cand_id}: "
                f"{len(self.regressions)} regressed of "
                f"{len(self.deltas)} matched, +{len(self.added)} "
                f"-{len(self.removed)})")


def _curves(rec: RunRecord) -> Tuple[np.ndarray, np.ndarray]:
    """A record's (scales, (S, V) curve matrix), derived from the PPG
    when the run recorded no explicit series (single-scale run)."""
    if rec.curves is not None and rec.scales is not None:
        return np.asarray(rec.scales, np.int64), np.asarray(rec.curves, float)
    if rec.ppg is None:
        raise ValueError(f"run {rec.run_id!r} has neither curves nor a PPG")
    t = np.asarray(rec.ppg.times_matrix(), float)
    if rec.clustering is not None:
        # representative rows stand for whole clusters: weight by size
        w = rec.clustering.counts.astype(float)[:, None]
        pos = t > 0.0
        wsum = (w * pos).sum(axis=0)
        row = np.divide((w * t).sum(axis=0, where=pos), wsum,
                        out=np.zeros(t.shape[1]), where=wsum > 0)
        n_procs = int(rec.clustering.n_procs)
    else:
        row = _merge_matrix(t, "mean", np.asarray(rec.ppg.var_matrix(),
                                                  float))
        n_procs = int(rec.ppg.n_procs)
    return np.asarray([n_procs], np.int64), row[None]


def _peak_row(rec: RunRecord) -> Optional[np.ndarray]:
    """Per-vertex max over the record's stored rows — the slowest
    process (or cluster representative) at each vertex.  A fault on 64
    of 65536 procs moves the mean by 0.1% but the peak by its full
    magnitude, so cross-run peak ratios catch abnormal-channel
    regressions the merged curve dilutes away."""
    if rec.ppg is None:
        return None
    return np.asarray(rec.ppg.times_matrix(), float).max(axis=0)


def _total_step_time(rec: RunRecord, curve_row: np.ndarray) -> float:
    """Step time for share normalization: the curve summed over the
    root's top-level vertices (children don't double-count parents)."""
    psg = rec.psg
    tops = [vid for vid in psg.children(psg.root)
            if vid < curve_row.size]
    total = float(curve_row[tops].sum()) if tops else float(curve_row.sum())
    return total if total > 0.0 else float(curve_row.sum())


def diff_runs(base: RunRecord, cand: RunRecord, *,
              ratio_thd: float = 1.25,
              slope_margin: float = 0.25,
              peak_thd: Optional[float] = None,
              min_share: float = 0.01,
              top_k: int = 0,
              backend: Optional[str] = None,
              device=None) -> RunDiff:
    """Compare two stored runs; see module docstring.

    ``peak_thd`` flags on the slowest-row ratio (see :func:`_peak_row`;
    catches few-proc faults a merged curve averages away); it defaults
    to ``ratio_thd`` and only applies when both runs were recorded at
    the same scale with a stored PPG.
    ``top_k`` > 0 truncates the flagged regression list; 0 keeps all.
    ``backend`` / ``device`` route the slope fits exactly like
    detection's knobs ("numpy" / "torch" on ``device``, ``cuda`` unless
    the CPU is asked for / "auto" / None -> SCALANA_DETECT_BACKEND)."""
    if base.psg is None or cand.psg is None:
        raise ValueError("both runs need a stored PSG to diff")
    alignment = align_psgs(base.psg, cand.psg)
    scales_a, M_a = _curves(base)
    scales_b, M_b = _curves(cand)

    jx, dev = _resolve_backend(backend, device)
    if jx is None:
        fit = fit_slopes
    else:
        def fit(scales, M, valid):
            return jx.fit_slopes(scales, M, valid, device=dev)
    backend_name = "numpy" if jx is None else "torch"
    slopes_a = (fit(scales_a, M_a, M_a > 0.0) if scales_a.size >= 2
                else np.zeros(M_a.shape[1]))
    slopes_b = (fit(scales_b, M_b, M_b > 0.0) if scales_b.size >= 2
                else np.zeros(M_b.shape[1]))

    # comparison scale: largest scale recorded by BOTH; if the runs share
    # none (different proc counts), compare each at its own top scale
    shared = np.intersect1d(scales_a, scales_b)
    if shared.size:
        ia = int(np.nonzero(scales_a == shared[-1])[0][0])
        ib = int(np.nonzero(scales_b == shared[-1])[0][0])
    else:
        ia, ib = scales_a.size - 1, scales_b.size - 1
    row_a, row_b = M_a[ia], M_b[ib]
    total_b = _total_step_time(cand, row_b)
    multi = scales_a.size >= 2 and scales_b.size >= 2
    peaks_a, peaks_b = _peak_row(base), _peak_row(cand)
    use_peaks = (peaks_a is not None and peaks_b is not None
                 and base.scale == cand.scale)
    pthd = ratio_thd if peak_thd is None else peak_thd

    deltas: List[VertexDelta] = []
    for va, vb in alignment.pairs:
        ta = float(row_a[va]) if va < row_a.size else 0.0
        tb = float(row_b[vb]) if vb < row_b.size else 0.0
        if ta <= 0.0 and tb <= 0.0:
            continue
        ratio = tb / ta if ta > 0.0 else float("inf")
        share = tb / total_b
        sa = float(slopes_a[va]) if va < slopes_a.size else 0.0
        sb = float(slopes_b[vb]) if vb < slopes_b.size else 0.0
        slope_delta = sb - sa
        pa = float(peaks_a[va]) if use_peaks and va < peaks_a.size else 0.0
        pb = float(peaks_b[vb]) if use_peaks and vb < peaks_b.size else 0.0
        peak_ratio = (pb / pa if pa > 0.0
                      else (float("inf") if pb > 0.0 else 0.0)) \
            if use_peaks else 0.0
        regressed = share >= min_share and (
            ratio >= ratio_thd
            or (multi and slope_delta >= slope_margin)
            or (use_peaks and peak_ratio >= pthd))
        v = cand.psg.vertices[vb]
        deltas.append(VertexDelta(
            vid_base=va, vid_cand=vb, kind=v.kind, name=v.name,
            source=v.source, base_time=ta, cand_time=tb, ratio=ratio,
            share=share, base_slope=sa, cand_slope=sb,
            slope_delta=slope_delta, base_peak=pa, cand_peak=pb,
            peak_ratio=peak_ratio, regressed=regressed,
            score=max(tb - ta, pb - pa, 0.0) * share))
    regressions = sorted((d for d in deltas if d.regressed),
                         key=lambda d: -d.score)
    if top_k > 0:
        regressions = regressions[:top_k]
    name_of = lambda psg, vid: (f"{psg.vertices[vid].kind} "
                                f"{psg.vertices[vid].name}")
    return RunDiff(
        base_id=base.run_id, cand_id=cand.run_id, alignment=alignment,
        deltas=deltas, regressions=regressions,
        removed=[name_of(base.psg, v) for v in alignment.a_only],
        added=[name_of(cand.psg, v) for v in alignment.b_only],
        base_scale=int(scales_a[ia]), cand_scale=int(scales_b[ib]),
        backend=backend_name)

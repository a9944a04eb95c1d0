"""Behavior clustering: compress P processes into K representatives.

The SPMD observation (Liu & Zhan's automatic-debugging line): processes
of a data-parallel job fall into a handful of behavior classes, so a
64k-proc run can be stored and diffed as K representative rows plus a
membership map.  A process's behavior vector is its per-vertex time row
concatenated with its column-sparse counter signature (``wait_s`` at the
Comm vertices) — exactly the data the detectors consume, so two procs
with the same vector are indistinguishable to detection.

Clustering is deterministic greedy k-centers (farthest-point
traversal): the first center is proc 0, each next center is the proc
farthest from every existing center, until either ``max_clusters``
centers exist or the farthest distance drops under ``tol`` times the
data scale.  Deterministic, O(P · K · F), no RNG — the same store
always clusters identically, which the run store's reproducibility
relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.graph import PPG, check_tree_format


def behavior_matrix(ppg: PPG, *, normalize: bool = False) -> np.ndarray:
    """(P, F) behavior vectors: per-vertex times + counter columns.

    Counter blocks stay column-sparse (k written columns each, not V),
    so F = V + sum_k — the vector is exactly the data detection sees.

    ``normalize`` scales each feature BLOCK by a max-abs so blocks are
    comparable: counters run many orders of magnitude hotter than
    seconds (flops ~1e9 vs times ~1e-2), so raw distances cluster on
    counter magnitude while a 2x time skew vanishes.  Blocks measured
    in SECONDS (the times block and ``*_s`` counters like ``wait_s``)
    share ONE common scale — a clean run's ~1e-5 s scheduling residue
    in ``wait_s`` must stay negligible next to ~1e-2 s step times, not
    get blown up to full spread by its own tiny block max.  Unit-less
    counter blocks are scaled by their own max (relative imbalance is
    the signal there)."""
    perf = ppg.perf
    times = np.asarray(ppg.times_matrix(), float)
    feats = [times]
    seconds = [True]
    for name in sorted(perf.counter_names()):
        vids, values, mask = perf.counter_columns(name)
        if vids.size:
            feats.append(np.where(mask, values, 0.0))
            seconds.append(name.endswith("_s"))
    if normalize:
        sec_max = max((float(np.abs(f).max())
                       for f, s in zip(feats, seconds) if s), default=0.0)
        out = []
        for f, s in zip(feats, seconds):
            m = sec_max if s else float(np.abs(f).max())
            out.append(f / m if m > 0.0 else f)
        feats = out
    return np.hstack(feats)


@dataclasses.dataclass
class Clustering:
    """K behavior clusters over P processes.

    ``membership[p]`` is the cluster of proc p; ``rep_procs[k]`` the
    global proc id of cluster k's representative (its center — an
    actual process, never an average); ``counts[k]`` the member count.
    ``rep_procs`` is sorted ascending so a representative sub-PPG built
    from it (:func:`representative_ppg`) has row r = rep of cluster r.
    """
    membership: np.ndarray           # (P,) int64
    rep_procs: np.ndarray            # (K,) int64, sorted
    counts: np.ndarray               # (K,) int64
    max_center_dist: float           # farthest member-to-center distance

    @property
    def n_procs(self) -> int:
        return int(self.membership.size)

    @property
    def n_clusters(self) -> int:
        return int(self.rep_procs.size)

    def members(self, k: int) -> np.ndarray:
        return np.nonzero(self.membership == k)[0]

    def compression(self) -> float:
        """Row-compression factor: P stored rows become K."""
        return self.n_procs / max(self.n_clusters, 1)

    def __repr__(self) -> str:
        return (f"Clustering({self.n_procs} procs -> {self.n_clusters} "
                f"clusters, max dist {self.max_center_dist:.3g})")

    # -- checkpoint-tree seam ------------------------------------------
    def to_tree(self) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        tree = {"membership": self.membership.copy(),
                "rep_procs": self.rep_procs.copy(),
                "counts": self.counts.copy()}
        meta = {"format": "clustering", "version": 1,
                "max_center_dist": float(self.max_center_dist)}
        return tree, meta

    @classmethod
    def from_tree(cls, tree: Mapping[str, Any],
                  meta: Optional[Mapping[str, Any]] = None) -> "Clustering":
        check_tree_format(meta, "clustering", 1)
        return cls(membership=np.asarray(tree["membership"], np.int64),
                   rep_procs=np.asarray(tree["rep_procs"], np.int64),
                   counts=np.asarray(tree["counts"], np.int64),
                   max_center_dist=float((meta or {}).get(
                       "max_center_dist", 0.0)))


def cluster_procs(ppg: PPG, *, max_clusters: int = 64,
                  tol: float = 0.01) -> Clustering:
    """Group processes by behavior vector; see module docstring.

    ``tol`` is relative: center selection stops early once the farthest
    proc sits within ``tol * max_row_norm`` of an existing center (all
    procs behaviorally identical -> 1 cluster, not ``max_clusters``).
    """
    if max_clusters < 1:
        raise ValueError(f"max_clusters must be positive: {max_clusters}")
    X = behavior_matrix(ppg, normalize=True)
    P = X.shape[0]
    norms = np.linalg.norm(X, axis=1)
    stop = float(tol) * float(norms.max(initial=0.0))

    def dist_to(p: int) -> np.ndarray:
        d = X - X[p]
        return np.sqrt(np.einsum("ij,ij->i", d, d))

    centers = [0]
    dmin = dist_to(0)
    nearest = np.zeros(P, np.int64)
    while len(centers) < min(max_clusters, P):
        far = int(np.argmax(dmin))
        if dmin[far] <= stop:
            break
        k = len(centers)
        centers.append(far)
        d = dist_to(far)
        closer = d < dmin
        nearest[closer] = k
        dmin = np.where(closer, d, dmin)
    # sort centers by proc id so representative-PPG row order is stable
    order = np.argsort(np.asarray(centers))
    relabel = np.empty(len(centers), np.int64)
    relabel[order] = np.arange(len(centers))
    membership = relabel[nearest]
    rep_procs = np.asarray(centers, np.int64)[order]
    counts = np.bincount(membership, minlength=rep_procs.size).astype(np.int64)
    return Clustering(membership=membership, rep_procs=rep_procs,
                      counts=counts, max_center_dist=float(dmin.max()))


def representative_ppg(ppg: PPG, clustering: Clustering) -> PPG:
    """The K-representative sub-PPG: row k is cluster k's center.

    Reuses the degraded-fleet compaction
    (:func:`repro_torch.monitor.degraded.live_subppg`): perf rows extracted
    through the RowBlock seam, collective groups intersected with the
    representative set, p2p edges remapped — so backtracking the
    representative graph walks real comm structure, not a stub."""
    from repro_torch.monitor.degraded import live_subppg
    return live_subppg(ppg, clustering.rep_procs)

"""Persistent run store: one directory per run, ONE persistence path.

A run is recorded as a checkpoint directory under the store root,
written through :mod:`repro_torch.checkpoint.store` — the exact atomic
npz-plus-manifest machinery the monitor's crash snapshots use.  The
payload is the object's own ``to_tree``/``from_tree`` seam (PPG -> PSG
+ perf store + comm index), so anything the monitor can snapshot the
run store can persist, bit for bit.

What a run holds:

* the **PPG** (full, or K representative rows + a
  :class:`~repro_torch.runs.cluster.Clustering` when recorded with
  ``cluster=K``),
* optional **scaling curves** — the (S, V) merged-time matrix across a
  ``{n_procs: PPG}`` series, which is what ``diff_runs`` fits slopes on,
* the **detect output** (NonScalable/Abnormal lists, JSON in the
  manifest),
* **metadata**: scale, git commit, wall time, schema version, plus
  anything the caller adds.

Run ids are zero-padded sequence numbers (``run_000003``) unless the
caller names the run; ``runs()`` lists them in recording order.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.checkpoint.store import load_checkpoint_tree, save_checkpoint
from repro_torch.core.detect import Abnormal, NonScalable
from repro_torch.core.graph import PPG, PSG
from repro_torch.runs.cluster import (Clustering, cluster_procs,
                                      representative_ppg)

RUN_SCHEMA_VERSION = 1

_RUN_PREFIX = "run_"


def git_commit(cwd: Optional[str] = None) -> str:
    """Current git commit hash, or "" when not in a repo / no git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_metadata(**extra: Any) -> Dict[str, Any]:
    """Standard run stamp: schema version, commit, wall time.

    The same stamp the JAX package's ``benchmarks/run.py`` writes into
    BENCH JSON lines, so bench payloads are ingestible as run metadata
    without mapping."""
    meta: Dict[str, Any] = {
        "schema_version": RUN_SCHEMA_VERSION,
        "commit": git_commit(),
        "wall_time": time.time(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
    }
    meta.update(extra)
    return meta


def _detect_to_json(detect: Mapping[str, Any]) -> Dict[str, Any]:
    """Detect output -> JSON-safe dict (int ``times`` keys -> pairs)."""
    out: Dict[str, Any] = {}
    for key, items in detect.items():
        rows = []
        for it in items:
            d = dataclasses.asdict(it) if dataclasses.is_dataclass(it) \
                else dict(it)
            if isinstance(d.get("times"), dict):
                d["times"] = [[int(s), float(t)]
                              for s, t in sorted(d["times"].items())]
            rows.append(d)
        out[str(key)] = rows
    return out


_DETECT_CLS = {"non_scalable": NonScalable, "abnormal": Abnormal}


def _detect_from_json(obj: Mapping[str, Any]) -> Dict[str, List[Any]]:
    """Inverse of :func:`_detect_to_json`: rebuild the dataclasses."""
    out: Dict[str, List[Any]] = {}
    for key, rows in obj.items():
        cls = _DETECT_CLS.get(key)
        items: List[Any] = []
        for d in rows:
            d = dict(d)
            if isinstance(d.get("times"), list):
                d["times"] = {int(s): float(t) for s, t in d["times"]}
            if cls is not None:
                fields = {f.name for f in dataclasses.fields(cls)}
                items.append(cls(**{k: v for k, v in d.items()
                                    if k in fields}))
            else:
                items.append(d)
        out[key] = items
    return out


@dataclasses.dataclass
class RunRecord:
    """One reloaded run. ``ppg`` is the stored graph — representative
    rows when the run was recorded with ``cluster=K`` (``clustering``
    then maps every original proc to its representative)."""
    run_id: str
    meta: Dict[str, Any]
    ppg: Optional[PPG]
    curves: Optional[np.ndarray]         # (S, V) merged times, or None
    scales: Optional[np.ndarray]         # (S,) proc counts, or None
    detect: Optional[Dict[str, List[Any]]]
    clustering: Optional[Clustering]
    path: str = ""

    @property
    def psg(self) -> Optional[PSG]:
        return self.ppg.psg if self.ppg is not None else None

    @property
    def scale(self) -> int:
        """The run's proc count (original fleet, not representatives)."""
        if self.clustering is not None:
            return self.clustering.n_procs
        if "scale" in self.meta:
            return int(self.meta["scale"])
        if self.scales is not None and len(self.scales):
            return int(np.max(self.scales))
        return int(self.ppg.n_procs) if self.ppg is not None else 0

    def __repr__(self) -> str:
        bits = [f"scale={self.scale}"]
        if self.scales is not None:
            bits.append(f"curves over {list(np.asarray(self.scales))}")
        if self.clustering is not None:
            bits.append(f"{self.clustering.n_clusters} reps")
        return f"RunRecord({self.run_id}: {', '.join(bits)})"


class RunStore:
    """Directory of recorded runs; see module docstring."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- listing -------------------------------------------------------
    def runs(self) -> List[str]:
        """Run ids in recording (lexicographic) order."""
        if not os.path.isdir(self.root):
            return []
        return sorted(
            name for name in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, name, "step_0",
                                           "manifest.json")))

    def __len__(self) -> int:
        return len(self.runs())

    def __contains__(self, run_id: str) -> bool:
        return run_id in self.runs()

    def _next_id(self) -> str:
        top = -1
        for name in self.runs():
            if name.startswith(_RUN_PREFIX):
                try:
                    top = max(top, int(name[len(_RUN_PREFIX):]))
                except ValueError:
                    pass
        return f"{_RUN_PREFIX}{top + 1:06d}"

    # -- record --------------------------------------------------------
    def record(self, *, ppg: Optional[PPG] = None,
               series: Optional[Mapping[int, PPG]] = None,
               curves: Optional[np.ndarray] = None,
               scales: Optional[Any] = None,
               detect: Optional[Mapping[str, Any]] = None,
               cluster: int = 0,
               strategy: str = "mean",
               run_id: Optional[str] = None,
               meta: Optional[Mapping[str, Any]] = None) -> str:
        """Persist one run; returns its id.

        Give either a single ``ppg``, or a ``series`` ({n_procs: PPG},
        scaling curves are computed and the top-scale PPG is stored), or
        a ``ppg`` plus precomputed ``curves``/``scales``.  ``cluster=K``
        compresses the stored PPG to at most K behavior representatives
        (full fleet recoverable per-cluster via the membership map)."""
        if series is not None:
            from repro_torch.runs.diff import scaling_curves  # avoid cycle
            sc, cv = scaling_curves(series, strategy=strategy)
            scales = sc if scales is None else scales
            curves = cv if curves is None else curves
            if ppg is None:
                ppg = series[int(max(series))]
        if ppg is None:
            raise ValueError("record() needs a ppg or a series")
        if (curves is None) != (scales is None):
            raise ValueError("curves and scales come together")

        run_meta = run_metadata(scale=int(ppg.n_procs))
        if meta:
            run_meta.update(meta)

        clustering = None
        stored = ppg
        if cluster:
            clustering = cluster_procs(ppg, max_clusters=int(cluster))
            stored = representative_ppg(ppg, clustering)

        ppg_tree, ppg_meta = stored.to_tree()
        tree: Dict[str, Any] = {"ppg": ppg_tree}
        extra: Dict[str, Any] = {
            "schema_version": RUN_SCHEMA_VERSION,
            "run_id": "",                    # filled below
            "run_meta": dict(run_meta),
            "ppg": ppg_meta,
        }
        if curves is not None:
            tree["curves"] = np.asarray(curves, float)
            tree["scales"] = np.asarray(scales, np.int64)
        if clustering is not None:
            cl_tree, cl_meta = clustering.to_tree()
            tree["clustering"] = cl_tree
            extra["clustering"] = cl_meta
        if detect is not None:
            extra["detect"] = _detect_to_json(detect)

        rid = run_id if run_id is not None else self._next_id()
        if os.path.isdir(os.path.join(self.root, rid, "step_0")):
            raise ValueError(f"run {rid!r} already recorded")
        extra["run_id"] = rid
        save_checkpoint(os.path.join(self.root, rid), 0, tree,
                        extra_meta=extra)
        return rid

    # -- load ----------------------------------------------------------
    def load(self, run_id: str) -> RunRecord:
        path = os.path.join(self.root, run_id)
        tree, extra = load_checkpoint_tree(path, 0)
        schema = int(extra.get("schema_version", 1))
        if schema > RUN_SCHEMA_VERSION:
            raise ValueError(f"run {run_id!r} has schema {schema}, "
                             f"newer than supported {RUN_SCHEMA_VERSION}")
        ppg = PPG.from_tree(tree["ppg"], extra.get("ppg")) \
            if "ppg" in tree else None
        curves = np.asarray(tree["curves"], float) \
            if "curves" in tree else None
        scales = np.asarray(tree["scales"], np.int64) \
            if "scales" in tree else None
        clustering = Clustering.from_tree(tree["clustering"],
                                          extra.get("clustering")) \
            if "clustering" in tree else None
        detect = _detect_from_json(extra["detect"]) \
            if "detect" in extra else None
        return RunRecord(run_id=run_id, meta=dict(extra.get("run_meta", {})),
                         ppg=ppg, curves=curves, scales=scales,
                         detect=detect, clustering=clustering, path=path)

    def latest(self) -> Optional[RunRecord]:
        ids = self.runs()
        return self.load(ids[-1]) if ids else None

    def __repr__(self) -> str:
        return f"RunStore({self.root!r}: {len(self)} runs)"

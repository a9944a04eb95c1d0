"""The always-on aggregator: fold shard deltas, detect, survive the fleet.

:class:`Monitor` turns the one-shot detect/backtrack pipeline into a
resident service over the transport seam:

* **Exact idempotent ingestion** — deltas carry the FULL state of their
  rows and apply strictly in per-host sequence order: each host has a
  high-water mark (last applied seq); a delta at ``seq <= high`` or
  already parked is a duplicate and is dropped, a future seq is PARKED
  until the gap fills.  Under any schedule of duplication, reordering
  and delay with eventual delivery, the rolling
  :class:`~repro_torch.core.shard.ShardedStore` converges bit-identically to
  the producers' shards — so the monitor's detection output equals a
  one-shot run on the fully-assembled store, exactly.
* **Heartbeats / staleness** — every delta or heartbeat refreshes its
  host's ``last_seen``; hosts silent for ``stale_after`` seconds are
  excluded from detection.
* **Graceful degradation** — with stale/dead hosts, detection runs on
  the live sub-fleet: row masks thread through ``detect_abnormal`` down
  to the device kernels (masked rows are EXCLUDED, not zero-polluted),
  backtracking walks the live-compacted PPG
  (:func:`~repro_torch.monitor.degraded.live_subppg`), and every report is
  annotated with fleet coverage.
* **Crash recovery** — the store + sequence windows snapshot to
  ``checkpoint/store.py`` every ``snapshot_every`` applied deltas;
  producers are acked only up to the last snapshotted seq, so
  :meth:`Monitor.restore` + ``producer.resend_unacked()`` converge to
  the same result as a crash-free run.
* **Detection cadence** — a report is produced when any trigger fires:
  ``detect_every`` applied deltas, ``drift_threshold`` fraction of procs
  updated, or ``interval`` seconds elapsed (injectable clock).  Reports
  stream through ``render_report(max_abnormal=)`` plus an optional
  ``on_report`` callback; :meth:`start`/:meth:`stop` run the poll loop
  in a daemon thread for always-on use.

Detection runs on ``backend="torch"`` by default, on ``device`` —
``cuda`` unless the CPU is asked for (``device="cpu"`` or
``backend="numpy"``): a sharded PPG feeds the fused abnormal op straight
from its device-resident shard buffers, which re-upload only dirty rows
per detect, and a degraded fleet's live rows are gathered on the device.
The module imports torch only where that backend resolves its device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_checkpoint_tree)
from repro_torch.core.backtrack import Path, backtrack
from repro_torch.core.detect import (Abnormal, _resolve_backend,
                                     detect_abnormal)
from repro_torch.core.graph import CommIndex, PPG, PSG
from repro_torch.core.report import render_report
from repro_torch.core.shard import ShardedStore
from repro_torch.monitor.clock import as_clock
from repro_torch.monitor.degraded import live_subppg, remap_paths
from repro_torch.monitor.producer import Heartbeat, ShardDelta
from repro_torch.monitor.transport import Transport
from repro_torch.monitor.validate import (fraction, positive_float,
                                          positive_int, probability)


def resolve_detect(backend: Optional[str], device=None):
    """Where a Monitor detects: ``("torch", torch.device)`` or
    ``("numpy", None)``.  None means "torch" (on ``cuda`` when ``device``
    is None, which raises where there is no card), never a silent
    "auto"; "auto" resolves as
    :func:`~repro_torch.core.detect.detect_abnormal` resolves it."""
    mod, dev = _resolve_backend("torch" if backend is None else backend,
                                device)
    return ("numpy", None) if mod is None else ("torch", dev)


@dataclasses.dataclass
class HostStatus:
    host: int
    high: int                  # last applied seq
    acked: int                 # last seq durably owned (<= high)
    parked: int                # out-of-order deltas waiting for a gap
    last_seen: float
    live: bool


@dataclasses.dataclass
class FleetStatus:
    hosts: List[HostStatus]
    live_hosts: int
    total_hosts: int
    live_procs: int
    total_procs: int


@dataclasses.dataclass
class MonitorReport:
    """One incremental detection result from the stream."""
    index: int
    text: str
    abnormal: List[Abnormal]
    paths: List[Path]
    coverage: str
    live_procs: int
    total_procs: int
    live_hosts: int
    total_hosts: int
    applied: int               # deltas applied so far (monitor lifetime)
    duplicates: int            # duplicates absorbed so far
    parked: int                # deltas currently parked

    @property
    def degraded(self) -> bool:
        return self.live_procs < self.total_procs


class Monitor:
    """Async ingestion/detection daemon over a rolling sharded store.

    ``backend`` / ``device`` pick where every detect runs: "torch" (the
    default) on ``device``, which is ``cuda`` when None and raises here
    where there is no card; "numpy" on the host; "auto" as
    :func:`~repro_torch.core.detect.detect_abnormal` resolves it."""

    def __init__(self, psg: PSG, ranges: Sequence[Tuple[int, int]],
                 transport: Transport, *,
                 comm: Optional[CommIndex] = None,
                 detect_every: Optional[int] = 8,
                 drift_threshold: Optional[float] = None,
                 interval: Optional[float] = None,
                 stale_after: Optional[float] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 16,
                 keep_snapshots: int = 3,
                 backend: Optional[str] = "torch",
                 device=None,
                 abnorm_thd: float = 1.3, min_share: float = 0.01,
                 top_k: int = 20, max_abnormal: int = 10,
                 max_reports: int = 64,
                 on_report: Optional[Callable[[MonitorReport], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 title: str = "ScalAna monitor report"):
        self.psg = psg
        self.transport = transport
        self.store = ShardedStore(ranges, len(psg.vertices))
        self.ppg = PPG(psg, self.store.n_procs, self.store)
        if comm is not None:
            self.ppg.comm = comm
        self.detect_every = positive_int("detect_every", detect_every,
                                         allow_none=True)
        self.drift_threshold = fraction("drift_threshold", drift_threshold,
                                        allow_none=True)
        self.interval = positive_float("interval", interval,
                                       allow_none=True)
        self.stale_after = positive_float("stale_after", stale_after,
                                          allow_none=True)
        # resolve now: no card and no device="cpu" raises here, not at
        # the first detect on a daemon thread
        self.backend, self.device = resolve_detect(backend, device)
        self.abnorm_thd = positive_float("abnorm_thd", abnorm_thd)
        self.min_share = probability("min_share", min_share)
        self.top_k = positive_int("top_k", top_k)
        self.max_abnormal = positive_int("max_abnormal", max_abnormal)
        self.max_reports = positive_int("max_reports", max_reports)
        self.on_report = on_report
        # one Clock behind the legacy callable knob (repro_torch.monitor.clock)
        self._clock = as_clock(clock)
        self.clock = self._clock.monotonic
        self.title = title

        H = len(self.store.shards)
        self.high: Dict[int, int] = {h: 0 for h in range(H)}
        self.acked: Dict[int, int] = {h: 0 for h in range(H)}
        self.parked: Dict[int, Dict[int, ShardDelta]] = \
            {h: {} for h in range(H)}
        now = self.clock()
        self.last_seen: Dict[int, float] = {h: now for h in range(H)}

        self.applied = 0
        self.duplicates = 0
        self.detects = 0
        self.reports: List[MonitorReport] = []
        self._applied_since_detect = 0
        self._touched = np.zeros(self.store.n_procs, bool)
        self._last_detect_time = now

        self.snapshot_dir = snapshot_dir
        self.snapshot_every = positive_int("snapshot_every", snapshot_every)
        self._applied_since_snapshot = 0
        self._snap_step = 0
        self._ckpt = CheckpointManager(
            snapshot_dir, keep=positive_int("keep_snapshots",
                                            keep_snapshots)) \
            if snapshot_dir else None

        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- ingestion -----------------------------------------------------
    def poll(self, max_messages: Optional[int] = None
             ) -> Optional[MonitorReport]:
        """Drain the transport, fold deltas, detect if a trigger fired.
        Returns the new report, or None."""
        with self._lock:
            for msg in self.transport.recv(max_messages):
                if isinstance(msg, ShardDelta):
                    self._ingest(msg)
                elif isinstance(msg, Heartbeat):
                    if msg.host in self.high:
                        self.last_seen[msg.host] = self.clock()
            if self._should_detect():
                return self._detect_locked()
            return None

    def _ingest(self, d: ShardDelta) -> None:
        host = d.host
        if host not in self.high:
            return                           # unknown host: ignore
        if d.seq <= self.high[host] or d.seq in self.parked[host]:
            self.duplicates += 1             # absorbed exactly, by sequence
            return
        self.parked[host][d.seq] = d
        # apply the in-order run the parking lot now covers
        while self.high[host] + 1 in self.parked[host]:
            nxt = self.parked[host].pop(self.high[host] + 1)
            self._apply(nxt)
            self.high[host] += 1
        self.last_seen[host] = self.clock()
        if self._ckpt is None:
            # no snapshots: delivery itself is as durable as we get
            self.acked[host] = self.high[host]
        elif self._applied_since_snapshot >= self.snapshot_every:
            self._snapshot_locked()

    def _apply(self, d: ShardDelta) -> None:
        sh = self.store.shards[d.host]
        sh.ensure_columns(d.block.n_cols)
        sh.apply_rows(d.block)               # block.rows are shard-local
        self.applied += 1
        self._applied_since_detect += 1
        self._applied_since_snapshot += 1
        self._touched[d.block.rows + sh.proc_start] = True

    # -- fleet health --------------------------------------------------
    def live_hosts(self) -> List[int]:
        if self.stale_after is None:
            return sorted(self.high)
        now = self.clock()
        return [h for h in sorted(self.high)
                if now - self.last_seen[h] <= self.stale_after]

    def proc_mask(self) -> np.ndarray:
        """(n_procs,) bool: True where the owning host is live."""
        mask = np.zeros(self.store.n_procs, bool)
        live = set(self.live_hosts())
        for h, sh in enumerate(self.store.shards):
            if h in live:
                mask[sh.proc_start:sh.proc_stop] = True
        return mask

    def fleet_status(self) -> FleetStatus:
        with self._lock:
            live = set(self.live_hosts())
            hosts = [HostStatus(host=h, high=self.high[h],
                                acked=self.acked[h],
                                parked=len(self.parked[h]),
                                last_seen=self.last_seen[h],
                                live=h in live)
                     for h in sorted(self.high)]
            mask = self.proc_mask()
            return FleetStatus(hosts=hosts, live_hosts=len(live),
                               total_hosts=len(hosts),
                               live_procs=int(mask.sum()),
                               total_procs=self.store.n_procs)

    # -- detection -----------------------------------------------------
    def _should_detect(self) -> bool:
        if self._applied_since_detect <= 0:
            return False
        if self.detect_every is not None \
                and self._applied_since_detect >= self.detect_every:
            return True
        if self.drift_threshold is not None \
                and self._touched.mean() >= self.drift_threshold:
            return True
        if self.interval is not None \
                and self.clock() - self._last_detect_time >= self.interval:
            return True
        return False

    def force_detect(self) -> MonitorReport:
        """Detect now, regardless of triggers (end-of-run / on-demand)."""
        with self._lock:
            return self._detect_locked()

    def _detect_locked(self) -> MonitorReport:
        mask = self.proc_mask()
        live_hosts = self.live_hosts()
        n_live = int(mask.sum())
        H = len(self.store.shards)
        degraded = n_live < self.store.n_procs
        coverage = (f"fleet coverage: {n_live}/{self.store.n_procs} procs, "
                    f"{len(live_hosts)}/{H} hosts live")
        if degraded:
            dead = sorted(set(self.high) - set(live_hosts))
            coverage += " (DEGRADED: host" + ("s " if len(dead) > 1 else " ") \
                + ", ".join(f"h{h}" for h in dead) + " excluded)"

        if not degraded:
            ab = detect_abnormal(self.ppg, abnorm_thd=self.abnorm_thd,
                                 min_share=self.min_share, top_k=self.top_k,
                                 backend=self.backend, device=self.device)
            paths = backtrack(self.ppg, [], ab)
        elif n_live == 0:
            ab, paths = [], []
        else:
            live_idx = np.nonzero(mask)[0]
            # masked detection: stale rows excluded down in the kernels
            ab = detect_abnormal(self.ppg, abnorm_thd=self.abnorm_thd,
                                 min_share=self.min_share, top_k=self.top_k,
                                 backend=self.backend, device=self.device,
                                 proc_mask=mask)
            # backtracking walks the live-compacted graph; its local proc
            # indices lift back to global ones for the report
            pos = np.full(self.store.n_procs, -1, np.intp)
            pos[live_idx] = np.arange(live_idx.size)
            sub = live_subppg(self.ppg, live_idx)
            ab_local = [dataclasses.replace(a, proc=int(pos[a.proc]))
                        for a in ab]
            paths = remap_paths(backtrack(sub, [], ab_local), live_idx)

        text = render_report(self.ppg, [], ab, paths, title=self.title,
                             max_abnormal=self.max_abnormal,
                             coverage=coverage)
        report = MonitorReport(
            index=self.detects, text=text, abnormal=ab, paths=paths,
            coverage=coverage, live_procs=n_live,
            total_procs=self.store.n_procs, live_hosts=len(live_hosts),
            total_hosts=H, applied=self.applied, duplicates=self.duplicates,
            parked=sum(len(p) for p in self.parked.values()))
        self.detects += 1
        self._applied_since_detect = 0
        self._touched[:] = False
        self._last_detect_time = self.clock()
        self.reports.append(report)
        del self.reports[:-self.max_reports]
        if self.on_report is not None:
            self.on_report(report)
        return report

    # -- snapshots / recovery ------------------------------------------
    def snapshot(self) -> None:
        """Snapshot the store + sequence windows now (normally automatic
        every ``snapshot_every`` applied deltas)."""
        with self._lock:
            if self._ckpt is None:
                raise RuntimeError("monitor has no snapshot_dir")
            self._snapshot_locked()

    def _snapshot_locked(self) -> None:
        # the store serializes through the one to_tree seam (same path
        # the run store persists with); the snapshot keeps its original
        # on-disk layout — per-shard trees under "shards", layout metas
        # under "shard_meta" — so pre-seam snapshots restore unchanged
        store_tree, store_meta = self.store.to_tree()
        tree: Dict[str, Dict] = {"shards": store_tree["shards"]}
        extra = {
            "ranges": store_meta["ranges"],
            "high": {str(h): int(s) for h, s in self.high.items()},
            "applied": self.applied,
            "duplicates": self.duplicates,
            "detects": self.detects,
            "shard_meta": {f"s{i}": m
                           for i, m in enumerate(store_meta["shards"])},
        }
        self._ckpt.save(self._snap_step, tree, blocking=True,
                        extra_meta=extra)
        self._snap_step += 1
        self._applied_since_snapshot = 0
        # the snapshot commit is the durability point: ack up to it
        for h in self.high:
            self.acked[h] = self.high[h]

    @classmethod
    def restore(cls, psg: PSG, transport: Transport, snapshot_dir: str,
                **kwargs) -> "Monitor":
        """Rebuild a crashed aggregator from its latest snapshot.

        The store contents and per-host sequence high-water marks come
        back exactly; parked (not-yet-applied) deltas were never acked,
        so producers' ``resend_unacked()`` replays them and the sequence
        windows drop whatever the snapshot already contained."""
        step = latest_step(snapshot_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed snapshot under {snapshot_dir!r}")
        tree, meta = load_checkpoint_tree(snapshot_dir, step)
        ranges = [tuple(r) for r in meta["ranges"]]
        mon = cls(psg, ranges, transport, snapshot_dir=snapshot_dir,
                  **kwargs)
        for i, sh in enumerate(mon.store.shards):
            key = f"s{i}"
            sh.load_tree(tree["shards"][key], meta["shard_meta"][key])
        mon.high = {int(h): int(s) for h, s in meta["high"].items()}
        mon.acked = dict(mon.high)
        mon.applied = int(meta["applied"])
        mon.duplicates = int(meta["duplicates"])
        mon.detects = int(meta["detects"])
        mon._snap_step = step + 1
        return mon

    def acked_seq(self, host: int) -> int:
        """What this host's producer may safely forget up to."""
        with self._lock:
            return self.acked.get(host, 0)

    # -- run-store archival --------------------------------------------
    def archive_to(self, run_store, *, run_id: Optional[str] = None,
                   meta: Optional[Dict] = None) -> str:
        """Record the current fleet state as one run in a
        :class:`repro_torch.runs.RunStore` — the always-on service accumulates
        history instead of discarding each report.

        The full PPG (sharded store, comm index, PSG) and the latest
        report's abnormal set go through the same ``to_tree`` seam the
        crash snapshot uses.  Returns the new run id."""
        with self._lock:
            report = self.reports[-1] if self.reports else None
            detect = {"abnormal": list(report.abnormal)} if report else None
            run_meta = {"scale": int(self.store.n_procs),
                        "applied": int(self.applied),
                        "detects": int(self.detects)}
            run_meta.update(meta or {})
            return run_store.record(ppg=self.ppg, detect=detect,
                                    run_id=run_id, meta=run_meta)

    # -- always-on service mode ----------------------------------------
    def start(self, poll_interval: float = 0.05) -> None:
        """Run the poll loop in a daemon thread until :meth:`stop`."""
        if self._thread is not None:
            raise RuntimeError("monitor already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.poll()
                self._stop.wait(poll_interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

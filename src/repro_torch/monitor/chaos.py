"""Seeded chaos harness: stream a known workload through a faulty fleet.

:func:`chaos_run` is both the monitor's acceptance test and a user-facing
rehearsal tool: it simulates a straggler workload into per-host truth
shards, replays that state to a
:class:`~repro_torch.monitor.aggregator.Monitor`
as multiple rounds of row deltas per host (each round widens the column
prefix, so out-of-order application would leave visibly stale rows)
through a :class:`~repro_torch.monitor.transport.FaultyTransport` with seeded
drop/duplicate/delay/ack-loss schedules, then checks the convergence
contract:

* clean fleet — the monitor's final detect/backtrack output is
  BIT-IDENTICAL to a one-shot run on the fully-assembled store;
* with permanently dead hosts — identical to a one-shot run restricted
  to the live rows, and the report states fleet coverage;
* with an aggregator crash mid-run — :meth:`Monitor.restore` from the
  latest snapshot plus producer ``resend_unacked()`` converges to the
  same result.

Everything is deterministic: seeded faults, an injected virtual clock,
and no-op backoff sleeps.  ``tools_torch/chaos_smoke_torch.py`` runs it
from the command line, on the card or (``--device cpu``) on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.backtrack import Path, backtrack
from repro_torch.core.detect import Abnormal, detect_abnormal
from repro_torch.core.graph import COMM, COMP, PSG, RowBlock
from repro_torch.core.inject import simulate
from repro_torch.core.shard import shard_ranges
from repro_torch.monitor.aggregator import (Monitor, MonitorReport,
                                            resolve_detect)
from repro_torch.monitor.degraded import live_subppg, remap_paths
from repro_torch.monitor.producer import ShardProducer
from repro_torch.monitor.transport import FaultyTransport


def build_chaos_psg(n_comp: int = 12) -> PSG:
    """A step-shaped workload: comp chain + one all-reduce (the straggler
    sink every backtrack path should reach)."""
    g = PSG()
    root = g.new_vertex("Root", "root")
    g.root = root.vid
    prev = None
    for i in range(n_comp):
        v = g.new_vertex(COMP, f"comp{i}", parent=root.vid,
                         source=f"model.py:{10 + i}")
        v.flops = 100.0
        if prev is not None:
            g.add_edge(prev, v.vid, "data")
        g.add_edge(root.vid, v.vid, "control")
        prev = v.vid
    c = g.new_vertex(COMM, "all_reduce", parent=root.vid, source="step.py:7")
    c.comm_kind, c.comm_bytes = "all_reduce", 1e6
    g.add_edge(prev, c.vid, "data")
    g.add_edge(root.vid, c.vid, "control")
    return g


def _truncated(block: RowBlock, n_cols: int) -> RowBlock:
    """The block as if only the first ``n_cols`` columns existed yet —
    the intermediate rounds' row state (the final round sends the full
    block, so in-order convergence reproduces the truth exactly)."""
    time = block.time.copy()
    var = block.time_var.copy()
    samples = block.samples.copy()
    mask = block.mask.copy()
    time[:, n_cols:] = 0.0
    var[:, n_cols:] = 0.0
    samples[:, n_cols:] = 0
    mask[:, n_cols:] = False
    counters = {}
    for name, (vids, values, cmask) in block.counters.items():
        keep = vids < n_cols
        if keep.any():
            counters[name] = (vids[keep].copy(), values[:, keep].copy(),
                              cmask[:, keep].copy())
    return RowBlock(rows=block.rows.copy(), n_cols=block.n_cols,
                    time=time, time_var=var, samples=samples, mask=mask,
                    counters=counters)


@dataclasses.dataclass
class ChaosResult:
    report: MonitorReport          # the monitor's final (converged) report
    abnormal_ref: List[Abnormal]   # one-shot reference output
    paths_ref: List[Path]
    abnormal_match: bool           # bit-identical detection?
    paths_match: bool
    coverage_stated: bool          # report text carries the coverage line
    transport_stats: Dict[str, int]
    duplicates_absorbed: int
    deltas_applied: int
    rounds: int
    # the socket scenario also proves the stronger invariants; the
    # queue-transport run leaves them True (they are implied by
    # abnormal/paths matching on identical stores)
    store_match: bool = True       # converged store == producers' shards
    report_match: bool = True      # rendered text == one-shot render

    @property
    def converged(self) -> bool:
        return self.abnormal_match and self.paths_match \
            and self.coverage_stated and self.store_match \
            and self.report_match


def _ab_key(a: Abnormal) -> tuple:
    return (a.vid, a.proc, a.time, a.typical, a.ratio)


def chaos_run(*, n_procs: int = 64, n_hosts: int = 8, rounds: int = 4,
              seed: int = 0, p_drop: float = 0.2, p_ack_loss: float = 0.1,
              p_dup: float = 0.15, p_delay: float = 0.3, max_delay: int = 3,
              outages: Sequence[Tuple[int, int]] = (),
              dead_hosts: Sequence[int] = (),
              snapshot_dir: Optional[str] = None,
              crash_after_round: Optional[int] = None,
              backend: Optional[str] = "torch",
              device=None,
              detect_every: Optional[int] = 4,
              n_comp: int = 12) -> ChaosResult:
    """Run the full chaos scenario; see the module docstring.

    ``dead_hosts`` never send anything and go stale; ``crash_after_round``
    (requires ``snapshot_dir``) discards the aggregator after that round
    and restores it from the latest snapshot.  The faulty schedule is
    fully determined by ``seed``.  ``backend`` / ``device`` pick where
    both the one-shot reference and every monitor detect run, as for
    :class:`~repro_torch.monitor.aggregator.Monitor`: torch on ``cuda``
    by default, raising where there is no card; the CPU is asked for
    with ``device="cpu"`` or ``backend="numpy"``.
    """
    if crash_after_round is not None and snapshot_dir is None:
        raise ValueError("crash_after_round requires snapshot_dir")
    backend, device = resolve_detect(backend, device)
    psg = build_chaos_psg(n_comp)
    V = len(psg.vertices)
    comm_vid = V - 1
    rng = np.random.default_rng(seed)
    straggler = int(rng.integers(n_procs))
    slow_vid = int(rng.integers(1, V - 1))

    def base(p, vid):
        v = psg.vertices[vid]
        return 0.0 if v.kind == COMM else 1.0 + 0.01 * vid

    ranges = shard_ranges(n_procs, n_hosts)
    sim = simulate(psg, n_procs, base,
                   inject={(straggler, slow_vid): 4.0},
                   comm_time=lambda *a: 0.05, jitter=0.0, seed=seed,
                   shards=ranges)
    truth_ppg = sim.ppg

    dead = set(int(h) for h in dead_hosts)
    H = len(truth_ppg.perf.shards)
    live_hosts = [h for h in range(H) if h not in dead]

    # -- one-shot reference ---------------------------------------------
    if dead:
        live_idx = np.concatenate(
            [np.arange(truth_ppg.perf.shards[h].proc_start,
                       truth_ppg.perf.shards[h].proc_stop)
             for h in live_hosts])
        sub = live_subppg(truth_ppg, live_idx)
        ab_local = detect_abnormal(sub, backend=backend, device=device)
        abnormal_ref = [dataclasses.replace(a, proc=int(live_idx[a.proc]))
                        for a in ab_local]
        paths_ref = remap_paths(backtrack(sub, [], ab_local), live_idx)
    else:
        abnormal_ref = detect_abnormal(truth_ppg, backend=backend,
                                       device=device)
        paths_ref = backtrack(truth_ppg, [], abnormal_ref)

    # -- the streaming fleet --------------------------------------------
    vclock = [0.0]
    clock = lambda: vclock[0]                           # noqa: E731
    transport = FaultyTransport(seed=seed, p_drop=p_drop,
                                p_ack_loss=p_ack_loss, p_dup=p_dup,
                                p_delay=p_delay, max_delay=max_delay,
                                outages=outages)
    monitor = Monitor(psg, ranges, transport, comm=truth_ppg.comm,
                      detect_every=detect_every, stale_after=2.5,
                      snapshot_dir=snapshot_dir, snapshot_every=n_hosts,
                      backend=backend, device=device, clock=clock)
    producers = {}
    from repro_torch.core.shard import ShardedStore
    prod_store = ShardedStore(ranges, V)
    for h in live_hosts:
        producers[h] = ShardProducer(h, prod_store.shards[h], transport,
                                     clock=clock, sleep=lambda s: None)

    every: Dict[int, np.ndarray] = {
        h: np.arange(prod_store.shards[h].n_procs) for h in live_hosts}
    for r in range(1, rounds + 1):
        c_r = max(1, (V * r) // rounds)
        for h in live_hosts:
            truth_block = truth_ppg.perf.shards[h].extract_rows(every[h])
            block = truth_block if r == rounds \
                else _truncated(truth_block, c_r)
            prod_store.shards[h].apply_rows(block)
            producers[h].flush()
        vclock[0] += 1.0
        monitor.poll()
        for h, p in producers.items():
            p.ack(monitor.acked_seq(h))
        if crash_after_round is not None and r == crash_after_round:
            # the aggregator dies with whatever its PERIODIC snapshots
            # captured; everything after the last commit was never acked,
            # so the producers still hold it
            del monitor
            monitor = Monitor.restore(psg, transport, snapshot_dir,
                                      comm=truth_ppg.comm,
                                      detect_every=detect_every,
                                      stale_after=2.5, backend=backend,
                                      device=device, clock=clock)
            monitor.last_seen = {h: clock() for h in monitor.last_seen}
            for p in producers.values():
                p.resend_unacked()

    # eventual delivery: release held messages, flush retry backlogs, and
    # poll until every live host's stream is fully applied
    for _ in range(64):
        transport.flush_held()
        for h, p in producers.items():
            p.flush(heartbeat=False)
        monitor.poll()
        if all(monitor.high[h] >= producers[h].seq
               and not monitor.parked[h] for h in live_hosts):
            break
    else:
        raise RuntimeError("chaos run did not converge: "
                           f"high={monitor.high} "
                           f"seqs={ {h: p.seq for h, p in producers.items()} }")
    vclock[0] += 5.0                         # dead hosts go stale
    for _ in range(64):                      # heartbeats are lossy too:
        for h in live_hosts:                 # repeat until every live host
            producers[h].send_heartbeat()    # is seen fresh
        monitor.poll()
        if monitor.live_hosts() == live_hosts:
            break
    else:
        raise RuntimeError(f"live set never settled: "
                           f"{monitor.live_hosts()} != {live_hosts}")

    report = monitor.force_detect()
    got = [_ab_key(a) for a in report.abnormal]
    want = [_ab_key(a) for a in abnormal_ref]
    paths_got = [(p.start_reason, p.nodes) for p in report.paths]
    paths_want = [(p.start_reason, p.nodes) for p in paths_ref]
    return ChaosResult(
        report=report, abnormal_ref=abnormal_ref, paths_ref=paths_ref,
        abnormal_match=got == want, paths_match=paths_got == paths_want,
        coverage_stated="fleet coverage:" in report.text,
        transport_stats=dict(transport.stats),
        duplicates_absorbed=monitor.duplicates,
        deltas_applied=monitor.applied, rounds=rounds)

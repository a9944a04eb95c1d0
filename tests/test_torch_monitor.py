"""The port's always-on Monitor against the JAX package's, on the CPU.

Both packages' chaos harnesses are deterministic (seeded faults, a
virtual clock), so the same scenario streams the same deltas through
each; the port's Monitor — with ``backend="torch", device="cpu"`` (the
fused abnormal op's plain version on device-resident shard buffers) and
with ``"numpy"`` — must give report text, abnormal lists and paths
identical to ``repro.monitor.Monitor(backend="numpy")``.  Also: the
three Monitors fed literally the same messages, round by round; snapshot
directories crossing between the packages both ways; the steady cycle's
16-row upload and single ``abnormal`` launch; the first detect after a
restore re-pinning every row; the daemon thread.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.monitor as R
import repro_torch.monitor as T
from repro.core.graph import CommIndex as RefCommIndex
from repro.core.inject import simulate as ref_simulate
from repro.core.shard import ShardedStore as RefShardedStore
from repro.core.shard import shard_ranges
from repro_torch.core.graph import CommIndex, RowBlock
from repro_torch.core.inject import simulate
from repro_torch.core.shard import ShardedStore
from repro_torch.kernels.detect_fused import ops
from tools_torch.chaos_smoke_torch import Tee, report_key

CPU = dict(backend="torch", device="cpu")


# ---------------------------------------------------------------------------
# the chaos harness, both packages, the same seeded scenarios
# ---------------------------------------------------------------------------

CHAOS_CASES = (
    [pytest.param(dict(seed=s), id=f"clean-{s}") for s in range(5)]
    + [pytest.param(dict(seed=s, dead_hosts=d), id=f"dead-{s}")
       for s, d in ((1, (2, 5)), (3, (0,)), (6, (1, 4, 7)))]
    + [pytest.param(dict(seed=5, p_drop=0.0, outages=((4, 12),)),
                    id="outage"),
       pytest.param(dict(seed=2, crash_after_round=2), id="crash"),
       pytest.param(dict(seed=4, crash_after_round=3, dead_hosts=(0,),
                         p_drop=0.3, p_dup=0.25, p_delay=0.4),
                    id="crash-dead-heavy"),
       pytest.param(dict(seed=7, n_procs=203, n_hosts=5, dead_hosts=(3,),
                         p_drop=0.25, p_dup=0.2, p_delay=0.35,
                         p_ack_loss=0.15), id="uneven-odd-live")])


@pytest.mark.parametrize("case", CHAOS_CASES)
def test_chaos_run_equals_the_reference(case, tmp_path):
    def run(mod, sub, **bk):
        kw = dict(case)
        if "crash_after_round" in kw:
            kw["snapshot_dir"] = str(tmp_path / sub)
        return mod.chaos_run(**kw, **bk)

    want = run(R, "ref", backend="numpy")
    assert want.converged
    for sub, bk in (("torch", CPU), ("numpy", dict(backend="numpy"))):
        got = run(T, sub, **bk)
        assert got.converged, (sub, got.transport_stats)
        assert report_key(got.report) == report_key(want.report), sub
        assert got.transport_stats == want.transport_stats
        assert (got.deltas_applied, got.duplicates_absorbed) \
            == (want.deltas_applied, want.duplicates_absorbed)
        assert got.report.degraded == bool(case.get("dead_hosts"))


# ---------------------------------------------------------------------------
# three Monitors fed literally the same messages
# ---------------------------------------------------------------------------

def _port_msg(msg):
    """A reference delta or heartbeat as the port's message."""
    if isinstance(msg, R.Heartbeat):
        return T.Heartbeat(host=msg.host, seq=msg.seq, time=msg.time)
    b = msg.block
    block = RowBlock(rows=b.rows.copy(), n_cols=b.n_cols, time=b.time.copy(),
                     time_var=b.time_var.copy(), samples=b.samples.copy(),
                     mask=b.mask.copy(),
                     counters={k: tuple(x.copy() for x in v)
                               for k, v in b.counters.items()})
    return T.ShardDelta(host=msg.host, seq=msg.seq,
                        proc_start=msg.proc_start, block=block)


class _Fanout(R.Transport):
    """The far side of the faults: each delivered message goes to the
    reference Monitor's queue and, converted, to each port Monitor's."""

    def __init__(self, ref_q, port_qs):
        self.ref_q, self.port_qs = ref_q, port_qs

    def send(self, msg):
        self.ref_q.send(msg)
        for q in self.port_qs:
            q.send(_port_msg(msg))

    def recv(self, max_messages=None):
        return []

    def pending(self):
        return 0


def _ref_fleet(n_procs, n_hosts, seed, n_comp=8):
    psg = R.build_chaos_psg(n_comp)
    V = len(psg.vertices)
    rng = np.random.default_rng(seed)
    inject = {(int(rng.integers(n_procs)), int(rng.integers(1, V - 1))): 4.0}
    ranges = shard_ranges(n_procs, n_hosts)
    sim = ref_simulate(psg, n_procs,
                       lambda p, v: 0.0 if psg.vertices[v].kind == "Comm"
                       else 1.0 + 0.01 * v + 0.001 * (p % 5),
                       inject=inject, comm_time=lambda *a: 0.05,
                       jitter=0.0, seed=seed, shards=ranges)
    return psg, sim.ppg, ranges


def _port_psg(n_comp=8):
    return T.build_chaos_psg(n_comp)


@pytest.mark.parametrize("seed,dead,faults", [
    (0, (), dict(p_drop=0.2, p_dup=0.2, p_delay=0.3, p_ack_loss=0.1)),
    (1, (2,), dict(p_drop=0.25, p_dup=0.2, p_delay=0.35, p_ack_loss=0.15)),
    (2, (1, 4), dict(p_dup=0.3, p_delay=0.4)),
    (3, (), dict(outages=((3, 9),), p_delay=0.3)),
])
def test_monitors_fed_the_same_messages_agree_every_round(seed, dead,
                                                          faults):
    n_procs, n_hosts = 45, 6
    psg, truth, ranges = _ref_fleet(n_procs, n_hosts, seed)
    V = len(psg.vertices)
    now = [0.0]
    clock = lambda: now[0]                                # noqa: E731
    qs = [R.QueueTransport(), T.QueueTransport(), T.QueueTransport()]
    faulty = R.FaultyTransport(_Fanout(qs[0], qs[1:]), seed=seed, **faults)
    kw = dict(detect_every=2, stale_after=2.5, clock=clock)
    ref = R.Monitor(psg, ranges, qs[0], comm=truth.comm, backend="numpy",
                    **kw)
    port_comm = _port_comm(truth)
    mons = [T.Monitor(_port_psg(), ranges, qs[1], comm=port_comm, **CPU,
                      **kw),
            T.Monitor(_port_psg(), ranges, qs[2], comm=port_comm,
                      backend="numpy", **kw)]
    live = [h for h in range(n_hosts) if h not in dead]
    # producer shards start narrow and grow a column prefix per round
    prod = RefShardedStore(ranges, 0)
    producers = {h: R.ShardProducer(h, prod.shards[h], faulty, clock=clock,
                                    sleep=lambda s: None) for h in live}
    reports = 0

    def poll_all():
        nonlocal reports
        faulty.recv()                    # one delivery tick for everyone
        want = ref.poll()
        for mon in mons:
            got = mon.poll()
            assert (got is None) == (want is None)
            if want is not None:
                assert report_key(got) == report_key(want)
                assert got.degraded == want.degraded
        reports += want is not None
        for h, p in producers.items():
            p.ack(ref.acked_seq(h))

    for r in range(1, 5):
        cols = max(1, (V * r) // 4)
        for h in live:
            sh = truth.perf.shards[h]
            rows = np.arange(sh.n_procs)
            if r % 2 == 0:               # a partial round: every other row
                rows = rows[r // 2 % 2::2]
            blk = sh.extract_rows(rows)
            blk.time = blk.time[:, :cols].copy()
            blk.time_var = blk.time_var[:, :cols].copy()
            blk.samples = blk.samples[:, :cols].copy()
            blk.mask = blk.mask[:, :cols].copy()
            blk.counters = {k: (vids[vids < cols], vals[:, vids < cols],
                                m[:, vids < cols])
                            for k, (vids, vals, m) in blk.counters.items()}
            blk.n_cols = cols
            prod.shards[h].apply_rows(blk)
            producers[h].flush()
        now[0] += 1.0
        poll_all()
    for h in live:                       # the final state: every full row
        sh = truth.perf.shards[h]
        prod.shards[h].apply_rows(sh.extract_rows(np.arange(sh.n_procs)))
        producers[h].flush()
    for _ in range(64):
        faulty.flush_held()
        for p in producers.values():
            p.flush(heartbeat=False)
        poll_all()
        if all(ref.high[h] >= producers[h].seq and not ref.parked[h]
               for h in live):
            break
    now[0] += 5.0
    for _ in range(64):
        for p in producers.values():
            p.send_heartbeat()
        poll_all()
        if ref.live_hosts() == live:
            break
    assert reports > 0
    want = ref.force_detect()
    for mon in mons:
        assert mon.live_hosts() == live
        assert mon.high == ref.high and mon.duplicates == ref.duplicates
        np.testing.assert_array_equal(mon.store.time_matrix(V),
                                      ref.store.time_matrix(V))
        assert report_key(mon.force_detect()) == report_key(want)
    assert want.degraded == bool(dead)


# ---------------------------------------------------------------------------
# snapshots cross between the packages
# ---------------------------------------------------------------------------

def _converged(mod, psg, truth_ppg, ranges, snapdir, **kw):
    tr = mod.QueueTransport()
    mon = mod.Monitor(psg, ranges, tr, comm=truth_ppg.comm,
                      detect_every=None, snapshot_dir=snapdir, **kw)
    prod = (RefShardedStore if mod is R else ShardedStore)(
        ranges, len(psg.vertices))
    for h in range(len(ranges)):
        sh = prod.shards[h]
        p = mod.ShardProducer(h, sh, tr, sleep=lambda s: None)
        for part in (np.arange(0, sh.n_procs, 2), np.arange(sh.n_procs)):
            sh.apply_rows(truth_ppg.perf.shards[h].extract_rows(part))
            p.flush(heartbeat=False)
    mon.poll()
    mon.force_detect()
    mon.snapshot()
    return mon


def _port_truth(n_procs, n_hosts, seed):
    psg = _port_psg()
    V = len(psg.vertices)
    rng = np.random.default_rng(seed)
    inject = {(int(rng.integers(n_procs)), int(rng.integers(1, V - 1))): 4.0}
    ranges = shard_ranges(n_procs, n_hosts)
    sim = simulate(psg, n_procs,
                   lambda p, v: 0.0 if psg.vertices[v].kind == "Comm"
                   else 1.0 + 0.01 * v + 0.001 * (p % 5),
                   inject=inject, comm_time=lambda *a: 0.05, jitter=0.0,
                   seed=seed, shards=ranges)
    return psg, sim.ppg, ranges


def _same_state(a, b, V):
    assert a.high == b.high and a.acked == b.acked
    assert (a.applied, a.duplicates, a.detects) \
        == (b.applied, b.duplicates, b.detects)
    np.testing.assert_array_equal(a.store.time_matrix(V),
                                  b.store.time_matrix(V))
    np.testing.assert_array_equal(a.store.var_matrix(V),
                                  b.store.var_matrix(V))
    assert sorted(a.store.counter_names()) == sorted(b.store.counter_names())
    for name in a.store.counter_names():
        for x, y in zip(a.store.counter_columns(name),
                        b.store.counter_columns(name)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_snapshot_restores_in_the_port(seed, tmp_path):
    psg, truth, ranges = _ref_fleet(40, 5, seed)
    V = len(psg.vertices)
    ref = _converged(R, psg, truth, ranges, str(tmp_path))
    back = T.Monitor.restore(_port_psg(), T.QueueTransport(), str(tmp_path),
                             comm=_port_comm(truth), detect_every=None,
                             **CPU)
    _same_state(back, ref, V)
    assert back._snap_step == ref._snap_step
    assert report_key(back.force_detect()) == report_key(ref.force_detect())


@pytest.mark.parametrize("seed", [0, 1])
def test_port_snapshot_restores_in_the_reference(seed, tmp_path):
    psg, truth, ranges = _port_truth(40, 5, seed)
    V = len(psg.vertices)
    port = _converged(T, psg, truth, ranges, str(tmp_path), **CPU)
    ref_comm = RefCommIndex.from_tree(*truth.comm.to_tree())
    back = R.Monitor.restore(R.build_chaos_psg(8), R.QueueTransport(),
                             str(tmp_path), comm=ref_comm, detect_every=None,
                             backend="numpy")
    _same_state(back, port, V)
    assert report_key(back.force_detect()) == report_key(port.force_detect())


def _port_comm(ref_ppg):
    return CommIndex.from_tree(*ref_ppg.comm.to_tree())


# ---------------------------------------------------------------------------
# the steady cycle, the restore, the daemon thread (torch on the CPU)
# ---------------------------------------------------------------------------

def _pair(n_procs=128, n_hosts=4, seed=3, snapdir=None):
    """A torch Monitor and a numpy one fed the same full fleet; returns
    (torch monitor, numpy monitor, send(host, rows, value), clock)."""
    psg, truth, ranges = _port_truth(n_procs, n_hosts, seed)
    now = [0.0]
    clock = lambda: now[0]                                # noqa: E731
    qs = [T.QueueTransport(), T.QueueTransport()]
    kw = dict(comm=truth.comm, detect_every=1, stale_after=2.5, clock=clock)
    mon = T.Monitor(psg, ranges, qs[0], snapshot_dir=snapdir,
                    snapshot_every=1 << 20, **CPU, **kw)
    ref = T.Monitor(psg, ranges, qs[1], backend="numpy", **kw)
    prod = ShardedStore(ranges, len(psg.vertices))
    producers = [T.ShardProducer(h, prod.shards[h], Tee(*qs), clock=clock,
                                 sleep=lambda s: None)
                 for h in range(n_hosts)]
    for h, p in enumerate(producers):
        sh = prod.shards[h]
        sh.apply_rows(truth.perf.shards[h].extract_rows(
            np.arange(sh.n_procs)))
        p.flush()

    def send(h, rows, value, vid=3):
        prod.shards[h].set_entries(np.asarray(rows), vid, value)
        producers[h].flush()

    return mon, ref, send, now, producers, kw


def test_steady_cycle_uploads_dirty_rows_and_launches_one_op():
    mon, ref, send, now, producers, _ = _pair()
    assert report_key(mon.poll()) == report_key(ref.poll())
    view = mon.ppg.device_view(mon.device)
    assert (view.full_uploads, view.last_upload_rows) == (1, 128)
    for i, h in enumerate((0, 2, 3)):
        send(h, np.arange(i, 16 + i), 3.0 + i)
        ops.reset_launch_counts()
        rep = mon.poll()
        assert view.last_upload_rows == 16 and view.full_uploads == 1
        assert dict(ops.launch_counts) == {"abnormal": 1}
        assert report_key(rep) == report_key(ref.poll())
    # a degraded cycle: host 1 stale, its rows dropped on the device
    now[0] += 5.0
    for h in (0, 2, 3):
        producers[h].send_heartbeat()
    send(0, np.arange(16), 9.0)
    ops.reset_launch_counts()
    rep = mon.poll()
    assert rep.degraded and rep.live_procs == 96
    assert view.last_upload_rows == 16
    assert dict(ops.launch_counts) == {"abnormal": 1}
    assert report_key(rep) == report_key(ref.poll())


def test_first_detect_after_restore_repins_every_row(tmp_path):
    mon, ref, send, now, producers, kw = _pair(snapdir=str(tmp_path))
    mon.poll()
    send(1, np.arange(16), 6.0)
    mon.poll()
    ref.poll()
    mon.snapshot()
    back = T.Monitor.restore(mon.psg, T.QueueTransport(), str(tmp_path),
                             **CPU, **kw)
    assert back.device == torch.device("cpu")
    rep = back.force_detect()
    view = back.ppg.device_view(back.device)
    assert (view.full_uploads, view.last_upload_rows) == (1, 128)
    assert report_key(rep) == report_key(ref.force_detect())


def test_daemon_thread_detects_on_the_torch_backend():
    mon, ref, send, now, producers, _ = _pair()
    mon.poll()
    ref.poll()
    done, errors = threading.Event(), []
    hook = threading.excepthook
    threading.excepthook = errors.append
    mon.on_report = lambda r: done.set()
    ops.reset_launch_counts()
    mon.start(poll_interval=0.002)
    try:
        send(2, np.arange(5, 21), 7.0)
        assert done.wait(timeout=30.0), "no report streamed"
    finally:
        mon.stop()
        threading.excepthook = hook
    assert not errors
    assert dict(ops.launch_counts) == {"abnormal": 1}
    assert report_key(mon.reports[-1]) == report_key(ref.poll())


def test_monitor_backend_knob():
    psg = _port_psg(4)
    # "auto" resolves at construction: the card where there is one
    mon = T.Monitor(psg, [(0, 4)], T.QueueTransport(), backend="auto")
    assert mon.backend == ("torch" if torch.cuda.is_available()
                           else "numpy")
    mon = T.Monitor(psg, [(0, 4)], T.QueueTransport(), backend="numpy")
    assert (mon.backend, mon.device) == ("numpy", None)
    with pytest.raises(ValueError, match="unknown detect backend"):
        T.Monitor(psg, [(0, 4)], T.QueueTransport(), backend="jax")
    mon = T.Monitor(psg, [(0, 4)], T.QueueTransport(), **CPU)
    assert (mon.backend, mon.device) == ("torch", torch.device("cpu"))
    assert dataclasses.is_dataclass(T.MonitorReport)

"""The port's wire protocol and socket transport against the JAX
package's, on the CPU.

The wire is where the two packages meet in a deployment: a producer of
one may stream to an aggregator of the other.  So the port's frames must
be byte-identical to the reference's for the same deltas, heartbeats and
acks (compressed or not, full rows and diff rows), each side's frames
must decode in the other to the same row state, and a reference fleet
streaming over real loopback TCP into the port's ``SocketServer`` must
leave the port's Monitor (``backend="torch", device="cpu"``) converged
to the reference's one-shot answer.  The socket chaos scenario runs in
both packages at the reference's sizes (32 processes, 4 hosts) and must
agree.
"""
import time

import numpy as np
import pytest

import repro.monitor as R
import repro.monitor.wire as RW
import repro_torch.monitor as T
import repro_torch.monitor.wire as TW
from repro.core.detect import detect_abnormal as ref_detect_abnormal
from repro.core.inject import simulate as ref_simulate
from repro.core.shard import ShardedStore as RefShardedStore
from repro.core.shard import shard_ranges
from repro_torch.core.graph import CommIndex
from repro_torch.core.shard import ShardedStore
from tools_torch.chaos_smoke_torch import report_key

V = 8                       # vertices in the little stores below
CPU = dict(backend="torch", device="cpu")
DEADLINE = 20.0


def _fill(stores, rng, procs, *, vids=range(1, V),
          counters=("PAPI_TOT_CYC", "PAPI_L2_DCM")):
    """The same random entries into every store of ``stores``."""
    for p in procs:
        for vid in vids:
            if rng.random() < 0.6:
                entry = dict(time=float(rng.random() * 10),
                             time_var=float(rng.random()),
                             samples=int(rng.integers(1, 5)),
                             counters={c: float(rng.integers(0, 50))
                                       for c in counters
                                       if rng.random() < 0.7})
                for st in stores:
                    st.set_entry(int(p), int(vid), entry["time"],
                                 time_var=entry["time_var"],
                                 samples=entry["samples"],
                                 counters=entry["counters"])


def _flush(mod, shard, host, seq):
    rows = shard.dirty_rows()
    block = shard.extract_rows(rows)
    shard.clear_dirty()
    return mod.ShardDelta(host=host, seq=seq, proc_start=shard.proc_start,
                          block=block)


def _apply(delta, store):
    sh = store.shards[delta.host]
    sh.ensure_columns(delta.block.n_cols)
    sh.apply_rows(delta.block)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_delta_frames_are_byte_identical_and_decode_across(seed, compress):
    rng = np.random.default_rng(seed)
    ranges = shard_ranges(12, 3)
    src_ref, src_port = RefShardedStore(ranges, V), ShardedStore(ranges, V)
    # replicas: the port decodes the reference's frames, and vice versa
    dst_port, dst_ref = ShardedStore(ranges, V), RefShardedStore(ranges, V)
    enc_ref = {h: RW.DeltaEncoder(compress=compress) for h in range(3)}
    enc_port = {h: TW.DeltaEncoder(compress=compress) for h in range(3)}
    dec_port = {h: TW.DeltaDecoder() for h in range(3)}
    dec_ref = {h: RW.DeltaDecoder() for h in range(3)}
    seqs = {h: 0 for h in range(3)}
    for rnd in range(6):
        for h in range(3):
            lo, hi = ranges[h]
            # later rounds touch few columns: diff rows, not full rows
            vids = range(1, V) if rnd < 2 else [int(rng.integers(1, V))]
            _fill((src_ref, src_port), rng,
                  [p for p in range(lo, hi) if rng.random() < 0.8],
                  vids=vids)
            if not src_ref.shards[h].dirty_rows().size:
                continue
            seqs[h] += 1
            d_ref = _flush(R, src_ref.shards[h], h, seqs[h])
            d_port = _flush(T, src_port.shards[h], h, seqs[h])
            frame_ref = RW.encode_message(d_ref, enc_ref[h])
            frame_port = TW.encode_message(d_port, enc_port[h])
            assert frame_port == frame_ref
            (typ, payload), = TW.FrameReader().feed(frame_ref)
            _apply(TW.decode_message(typ, payload, dec_port[h]), dst_port)
            (typ, payload), = RW.FrameReader().feed(frame_port)
            _apply(RW.decode_message(typ, payload, dec_ref[h]), dst_ref)
    assert dict(enc_port[0].stats) == dict(enc_ref[0].stats)
    if compress:
        assert sum(e.stats.get("diff_rows", 0) for e in enc_port.values())
    assert T.stores_equal(src_port, dst_port, V)
    assert R.stores_equal(src_ref, dst_ref, V)
    np.testing.assert_array_equal(dst_port.time_matrix(V),
                                  src_ref.time_matrix(V))
    np.testing.assert_array_equal(dst_port.var_matrix(V),
                                  src_ref.var_matrix(V))


def test_heartbeat_and_ack_frames_are_byte_identical():
    hb = dict(host=5, seq=77, time=1234.5)
    assert TW.encode_message(T.Heartbeat(**hb)) \
        == RW.encode_message(R.Heartbeat(**hb))
    acks = {3: 9, 0: 1, 12: 400}
    frame = RW.encode_message(RW.Ack(acks=acks))
    assert TW.encode_message(TW.Ack(acks=acks)) == frame
    (typ, payload), = TW.FrameReader().feed(frame)
    assert TW.decode_message(typ, payload) == TW.Ack(acks=acks)
    (typ, payload), = TW.FrameReader().feed(RW.encode_message(
        R.Heartbeat(**hb)))
    assert TW.decode_message(typ, payload) == T.Heartbeat(**hb)


def test_frame_reader_resyncs_a_reference_stream_alike():
    frames = [RW.encode_frame(RW.MSG_HEARTBEAT, bytes([i]) * (10 + i))
              for i in range(6)]
    bad = bytearray(frames[2])
    bad[RW.HEADER.size + 1] ^= 0xFF                 # a CRC error
    stream = (frames[0] + b"\x00\xffnoise" + frames[1] + bytes(bad)
              + b"SCA" + frames[3] + frames[4] + frames[5][:9])
    readers = (RW.FrameReader(), TW.FrameReader())
    got = [[], []]
    for i in range(0, len(stream), 7):               # awkward chunks
        for r, out in zip(readers, got):
            out += r.feed(stream[i:i + 7])
    for r in readers:
        r.close()
    assert got[0] == got[1] and len(got[0]) == 4
    assert dict(readers[0].stats) == dict(readers[1].stats)


# ---------------------------------------------------------------------------
# a reference fleet streaming into the port's server over real TCP
# ---------------------------------------------------------------------------

def _ref_fleet(n_procs=16, n_hosts=4, n_comp=6, seed=0):
    psg = R.build_chaos_psg(n_comp)
    ranges = shard_ranges(n_procs, n_hosts)
    sim = ref_simulate(psg, n_procs,
                       lambda p, v: 0.0 if psg.vertices[v].kind == "Comm"
                       else 1.0 + 0.01 * v,
                       inject={(5, 2): 4.0}, comm_time=lambda *a: 0.05,
                       jitter=0.0, seed=seed, shards=ranges)
    return psg, ranges, sim.ppg


@pytest.mark.parametrize("compress", [False, True])
def test_reference_producers_stream_into_the_port_over_tcp(compress):
    psg, ranges, truth = _ref_fleet()
    n_hosts, n_v = len(ranges), len(psg.vertices)
    comm = CommIndex.from_tree(*truth.comm.to_tree())
    with T.SocketServer() as srv:
        mon = T.Monitor(T.build_chaos_psg(6), ranges, srv, comm=comm,
                        detect_every=None, **CPU)
        prod = RefShardedStore(ranges, n_v)
        producers, links, transports = {}, [], []
        try:
            for h in range(n_hosts):
                tr = R.SocketTransport(srv.address, seed=h,
                                       compress=compress)
                transports.append(tr)
                producers[h] = R.ShardProducer(h, prod.shards[h], tr)
                links.append(R.ProducerLink(producers[h], tr,
                                            resend_after=0.05))
            for part in (slice(0, None, 2), slice(None)):
                for h in range(n_hosts):
                    sh = prod.shards[h]
                    rows = np.arange(sh.n_procs)[part]
                    sh.apply_rows(truth.perf.shards[h].extract_rows(rows))
                    producers[h].flush()
            deadline = time.monotonic() + DEADLINE
            while not all(mon.high[h] >= producers[h].seq
                          and not mon.parked[h] for h in range(n_hosts)):
                assert time.monotonic() < deadline, srv.stats()
                for link in links:
                    link.tick()
                mon.poll()
                srv.send_acks({h: mon.acked_seq(h) for h in range(n_hosts)})
                time.sleep(0.002)
            # acks flow back to the reference producers
            while any(p.acked < p.seq for p in producers.values()):
                assert time.monotonic() < deadline
                srv.send_acks({h: mon.acked_seq(h) for h in range(n_hosts)})
                for tr in transports:
                    tr.recv()
                time.sleep(0.002)
        finally:
            for tr in transports:
                tr.close()
        rep = mon.force_detect()
    np.testing.assert_array_equal(mon.store.time_matrix(n_v),
                                  truth.perf.time_matrix(n_v))
    want = ref_detect_abnormal(truth, backend="numpy")
    assert want
    assert [(a.vid, a.proc, a.time, a.typical) for a in rep.abnormal] \
        == [(a.vid, a.proc, a.time, a.typical) for a in want]


# ---------------------------------------------------------------------------
# the socket chaos scenario, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    pytest.param(dict(seed=0), id="seed0"),
    pytest.param(dict(seed=1, compress=False), id="uncompressed"),
    pytest.param(dict(seed=2, p_reset=0.12, p_tear=0.1, p_garbage=0.15,
                      p_stall=0.05), id="smoke-faults"),
    pytest.param(dict(seed=3, p_reset=0.25, p_tear=0.2, p_garbage=0.3,
                      p_stall=0.1, rounds=4,
                      faulty_wrap=dict(p_drop=0.2, p_ack_loss=0.15,
                                       p_dup=0.15, p_delay=0.2,
                                       max_delay=2)), id="stacked"),
    pytest.param(dict(seed=5, p_reset=0.0, p_tear=0.0, p_garbage=0.3,
                      p_stall=0.0, rounds=4), id="garbage-only"),
])
def test_socket_chaos_equals_the_reference(kw):
    want = R.socket_chaos_run(**kw)
    assert want.converged
    got = T.socket_chaos_run(**kw, **CPU)
    assert got.converged, got.transport_stats
    assert got.store_match and got.report_match
    assert report_key(got.report) == report_key(want.report)

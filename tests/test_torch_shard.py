"""The torch device store: ``TorchShardView`` on the CPU.

The cases of the JAX package's device-view tests, on the port's view
with ``device="cpu"``: the pinned tensors equal the host blocks after any
interleaving of writes and refreshes, a refresh uploads exactly the dirty
rows, ``revision`` and the merged-column cache follow every change, and
a refresh that fails — on the full upload or midway through the dirty
rows — loses no row for the retry.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (COMM, COMP, PSG, PerfStore, ShardedStore,
                              TorchShardView, detect_abnormal,
                              detect_non_scalable)
from repro_torch.core.inject import simulate
from repro_torch.kernels.detect_fused import ops

CPU = "cpu"


def _step_psg(n_procs, n_comp=6):
    g = PSG()
    root = g.new_vertex("Root", "root")
    g.root = root.vid
    prev = None
    for i in range(n_comp):
        v = g.new_vertex(COMP, f"c{i}", parent=root.vid, source=f"m.py:{i}")
        g.add_edge(root.vid, v.vid, "control")
        if prev is not None:
            g.add_edge(prev, v.vid, "data")
        prev = v.vid
    p2p = g.new_vertex(COMM, "ppermute", parent=root.vid, source="m.py:h")
    p2p.comm_kind, p2p.comm_bytes = "ppermute", 1e5
    p2p.p2p_pairs = [(p, (p + 1) % n_procs) for p in range(n_procs)]
    g.add_edge(prev, p2p.vid, "data")
    g.add_edge(root.vid, p2p.vid, "control")
    ar = g.new_vertex(COMM, "psum", parent=root.vid, source="m.py:ar")
    ar.comm_kind, ar.comm_bytes = "all_reduce", 1e6
    g.add_edge(p2p.vid, ar.vid, "data")
    g.add_edge(root.vid, ar.vid, "control")
    return g


def _base(p, vid):
    return 0.01 * (1 + p % 3) + 0.001 * vid


def _sharded(n_procs, n_hosts, seed=0, inject=None):
    return simulate(_step_psg(n_procs), n_procs, _base, inject=inject,
                    seed=seed, shards=n_hosts).ppg


def _ab_key(ab):
    return [(a.proc, a.vid, a.time, a.typical) for a in ab]


def _assert_buffers_match(view, V, dtype=np.float64):
    """Every pinned tensor equals its host block (padded to V columns,
    in the view's dtype)."""
    for i, blk in enumerate(view.blocks):
        np.testing.assert_array_equal(view.time_blocks()[i].numpy(),
                                      blk.time_matrix(V).astype(dtype))
        np.testing.assert_array_equal(view.var_blocks()[i].numpy(),
                                      blk.var_matrix(V).astype(dtype))
        for name in blk.counter_names():
            vids, values, mask = blk.counter_columns(name)
            key, buf = view.counter_blocks(name)[i]
            assert key == tuple(vids.tolist())
            np.testing.assert_array_equal(
                buf.numpy(), np.where(mask, values, 0.0).astype(dtype))


def test_incremental_upload_after_interleaved_writes():
    g = _step_psg(16)
    ppg = simulate(g, 16, _base, shards=[(0, 5), (5, 11), (11, 16)]).ppg
    V = len(g.vertices)
    view = ppg.device_view(CPU)
    assert view is ppg.device_view(CPU)                # cached, one per PPG
    assert view.device == torch.device("cpu")

    view.refresh(V)                                    # first: full upload
    assert view.full_uploads == 1 and view.last_upload_rows == 16
    _assert_buffers_match(view, V)
    full_bytes = view.last_upload_bytes

    view.refresh(V)                                    # clean: no transfer
    assert view.last_upload_rows == 0 and view.last_upload_bytes == 0

    rng = np.random.default_rng(0)
    for round_ in range(4):
        rows = np.unique(rng.integers(0, 16, size=rng.integers(1, 5)))
        vid = int(rng.integers(0, V))
        ppg.perf.set_entries(rows, vid, 1.0 + round_,
                             counters={"wait_s": 0.25})
        if round_ == 2:                                # scalar write path
            ppg.perf.set_entry(2, 1, 3.5, accumulate=True)
            rows = np.union1d(rows, [2])
        view.refresh(V)
        assert view.full_uploads == 1                  # still incremental
        assert view.last_upload_rows == rows.size
        assert view.last_upload_bytes < full_bytes
        _assert_buffers_match(view, V)
        # detection agrees with the numpy reference after every round
        assert _ab_key(detect_abnormal(ppg, backend="torch", device=CPU)) \
            == _ab_key(detect_abnormal(ppg, backend="numpy"))

    # a dtype flip re-pins in full (no stale f64 buffers feed f32 runs)
    view.refresh(V, dtype=np.float32)
    assert view.full_uploads == 2 and view.last_upload_rows == 16
    assert view.time_blocks()[0].dtype == torch.float32
    _assert_buffers_match(view, V, np.float32)


def test_pinned_tensors_never_alias_host_blocks():
    ppg = _sharded(8, 2)
    view = ppg.device_view(CPU)
    view.refresh()
    before = view.time_blocks()[0].clone()
    ppg.perf.shards[0].time[0, 0] = 123.0              # no dirty flag
    assert torch.equal(view.time_blocks()[0], before)


def test_single_store_and_errors():
    store = PerfStore(6, 4)
    store.set_column(2, np.arange(6.0))
    view = TorchShardView(store, device=CPU)
    with pytest.raises(RuntimeError):                  # read before refresh
        view.time_blocks()
    view.refresh(4)
    assert len(view.time_blocks()) == 1
    np.testing.assert_array_equal(view.time_blocks()[0].numpy(),
                                  store.time_matrix(4))
    assert view.row_ranges() == [(0, 6)]
    with pytest.raises(TypeError):
        TorchShardView({}, device=CPU)
    with pytest.raises(TypeError):
        view.refresh(4, dtype=np.int64)


def test_upload_accounting_counts_rows_and_bytes():
    ppg = _sharded(12, 3)
    V = len(ppg.psg.vertices)
    view = ppg.device_view(CPU)
    view.refresh(V)
    first = view.last_upload_bytes
    assert view.total_upload_bytes == first and view.refreshes == 1
    ppg.perf.set_entries(np.array([0, 5, 11]), 1, 2.0)
    view.refresh(V)
    assert view.last_upload_rows == 3
    counters = sum(
        3 * len(view.counter_blocks(name)[0][0]) * 8
        for name in ppg.perf.shards[0].counter_names())
    assert view.last_upload_bytes == 3 * V * 8 * 2 + counters
    assert view.total_upload_bytes == first + view.last_upload_bytes
    assert view.refreshes == 2


def test_revision_and_merged_cache_follow_every_change():
    ppg = _sharded(12, 3)
    V = len(ppg.psg.vertices)
    view = ppg.device_view(CPU)
    view.refresh(V)
    rev = view.revision
    col = torch.ones(4, V, dtype=torch.float64)
    view.cache_merged_column(col)
    view.refresh(V)                                    # clean: cache holds
    assert view.revision == rev and view.merged_column() is col
    ppg.perf.set_entry(3, 2, 5.0)
    view.refresh(V)                                    # a write: one bump
    assert view.revision == rev + 1 and view.merged_column() is None
    view.cache_merged_column(col)
    view.refresh(V + 1)                                # layout change
    assert view.merged_column() is None
    view.cache_merged_column(col)
    view.refresh(V + 1, dtype=np.float32)              # dtype change
    assert view.merged_column() is None


def test_historical_write_refills_exactly_that_column():
    g = _step_psg(16)
    series = {n: simulate(g, n, lambda p, v, n=n: _base(p, v) + 0.02 / n,
                          shards=min(4, n)).ppg for n in (4, 8, 16)}
    scales = sorted(series)
    ops.reset_launch_counts()
    first = detect_non_scalable(series, backend="torch", device=CPU,
                                min_share=0.0)
    assert ops.launch_counts["merge_column"] == 2
    ops.reset_launch_counts()
    again = detect_non_scalable(series, backend="torch", device=CPU,
                                min_share=0.0)
    assert dict(ops.launch_counts) == {"non_scalable_live": 1}
    assert [d.vid for d in again] == [d.vid for d in first]
    victim = series[scales[0]]
    victim.perf.set_entry(1, 1, 9.0)
    ops.reset_launch_counts()
    got = detect_non_scalable(series, backend="torch", device=CPU,
                              min_share=0.0)
    assert ops.launch_counts["merge_column"] == 1      # only the victim
    want = detect_non_scalable(series, backend="numpy", min_share=0.0)
    assert [d.vid for d in got] == [d.vid for d in want]
    for a, b in zip(got, want):
        assert abs(a.slope - b.slope) <= 1e-12 * max(abs(b.slope), 1.0)


def test_steady_detect_uploads_dirty_rows_and_launches_twice():
    g = _step_psg(32)
    series = {n: simulate(g, n, lambda p, v, n=n: _base(p, v) + 0.02 / n,
                          shards=min(4, n)).ppg for n in (4, 8, 32)}
    live = series[32]
    detect_non_scalable(series, backend="torch", device=CPU, min_share=0.0)
    detect_abnormal(live, backend="torch", device=CPU)
    view = live.device_view(CPU)
    rows = np.arange(7, 23)
    live.perf.set_entries(rows, 2, 0.5)
    seen = []
    ops.on_launch = seen.append
    try:
        ns = detect_non_scalable(series, backend="torch", device=CPU,
                                 min_share=0.0)
        assert view.last_upload_rows == rows.size
        ab = detect_abnormal(live, backend="torch", device=CPU)
        assert view.last_upload_rows == 0
    finally:
        ops.on_launch = None
    assert seen == ["non_scalable_live", "abnormal"]
    assert _ab_key(ab) == _ab_key(detect_abnormal(live, backend="numpy"))
    assert [d.vid for d in ns] == [d.vid for d in detect_non_scalable(
        series, backend="numpy", min_share=0.0)]
    for n in (4, 8):
        assert series[n].device_view(CPU).kernel_launches == 1


def test_refresh_failure_keeps_dirty_rows_for_retry(monkeypatch):
    """An upload that raises before any write leaves the dirty flags and
    the pinned tensors untouched; the retry re-uploads exactly the rows
    the failed call lost."""
    sharded = _sharded(12, 3, seed=2)
    view = TorchShardView(sharded.perf, device=CPU)
    view.refresh()
    assert all(not b.dirty_rows().size for b in view.blocks)
    sharded.perf.set_entry(1, 1, 9.0)
    sharded.perf.set_entry(7, 2, 9.5)
    calls = {"n": 0}
    real = TorchShardView._rows_slab

    def dying(self, mat, rows, V, dtype):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected device OOM")
        return real(self, mat, rows, V, dtype)

    monkeypatch.setattr(TorchShardView, "_rows_slab", dying)
    before = [t.clone() for t in view.time_blocks()]
    with pytest.raises(RuntimeError, match="injected device OOM"):
        view.refresh()
    monkeypatch.undo()
    dirty = np.concatenate([b.dirty_rows() + b.proc_start
                            for b in view.blocks])
    assert sorted(dirty.tolist()) == [1, 7]
    for buf, ref in zip(view.time_blocks(), before):
        assert torch.equal(buf, ref)
    view.refresh()
    assert view.last_upload_rows == 2
    assert all(not b.dirty_rows().size for b in view.blocks)
    host = np.concatenate([b.time for b in view.blocks], axis=0)
    dev = torch.cat(view.time_blocks()).numpy()
    np.testing.assert_array_equal(dev, host)


def test_refresh_failure_after_an_in_place_write_serves_no_stale_column(
        monkeypatch):
    """A failure after one block was written in place: ``revision`` was
    bumped and the merged cache dropped before that write, the dirty
    flags survive, and the retry converges."""
    sharded = _sharded(12, 3, seed=4)
    view = TorchShardView(sharded.perf, device=CPU)
    view.refresh()
    view.cache_merged_column(torch.zeros(4, 3))
    rev = view.revision
    sharded.perf.set_entry(1, 1, 9.0)                  # block 0
    sharded.perf.set_entry(9, 2, 9.5)                  # block 2
    calls = {"n": 0}
    real = TorchShardView._rows_slab

    def dying(self, mat, rows, V, dtype):
        calls["n"] += 1
        if calls["n"] >= 3:                            # block 2's first slab
            raise RuntimeError("injected transfer error")
        return real(self, mat, rows, V, dtype)

    monkeypatch.setattr(TorchShardView, "_rows_slab", dying)
    with pytest.raises(RuntimeError, match="injected transfer error"):
        view.refresh()
    monkeypatch.undo()
    assert view.revision == rev + 1                    # bumped before write
    assert view.merged_column() is None                # never stale
    assert view.time_blocks()[0][1, 1].item() == 9.0   # block 0 written
    dirty = np.concatenate([b.dirty_rows() + b.proc_start
                            for b in view.blocks])
    assert sorted(dirty.tolist()) == [1, 9]            # nothing lost
    view.refresh()
    assert view.last_upload_rows == 2
    assert view.revision == rev + 2
    host = np.concatenate([b.time for b in view.blocks], axis=0)
    np.testing.assert_array_equal(torch.cat(view.time_blocks()).numpy(),
                                  host)


def test_refresh_failure_on_full_upload_leaves_view_unprimed(monkeypatch):
    sharded = _sharded(8, 2, seed=3)
    view = TorchShardView(sharded.perf, device=CPU)

    def dying(self, mat, rows, V, dtype):
        raise RuntimeError("boom on first slab")

    monkeypatch.setattr(TorchShardView, "_rows_slab", dying)
    with pytest.raises(RuntimeError, match="boom on first slab"):
        view.refresh()
    monkeypatch.undo()
    with pytest.raises(RuntimeError):
        view.time_blocks()                             # still unprimed
    assert all(b.dirty_rows().size == b.n_procs for b in view.blocks)
    view.refresh()
    host = np.concatenate([b.time for b in view.blocks], axis=0)
    np.testing.assert_array_equal(torch.cat(view.time_blocks()).numpy(),
                                  host)


def test_device_proc_mask_reuses_buffers_across_masks():
    n_procs = 12
    sharded = _sharded(n_procs, 3, seed=1, inject={(1, 2): 5.0})
    full = detect_abnormal(sharded, backend="torch", device=CPU)
    view = sharded.device_view(CPU)
    uploads = view.total_upload_bytes
    for dead in (0, 4, 8):
        mask = np.ones(n_procs, bool)
        mask[dead] = False
        got = detect_abnormal(sharded, backend="torch", device=CPU,
                              proc_mask=mask)
        assert _ab_key(got) == _ab_key(
            detect_abnormal(sharded, backend="numpy", proc_mask=mask))
    assert view.total_upload_bytes == uploads          # no re-transfer
    assert _ab_key(detect_abnormal(sharded, backend="torch",
                                   device=CPU)) == _ab_key(full)


def test_device_view_is_cached_across_device_spellings():
    ppg = _sharded(8, 2)
    assert isinstance(ppg.perf, ShardedStore)
    a = ppg.device_view(CPU)
    assert ppg.device_view(torch.device("cpu")) is a


def test_cuda_view_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _sharded(8, 2).device_view()

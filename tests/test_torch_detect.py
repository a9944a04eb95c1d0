"""The port's detectors on the torch backend against the JAX package's
numpy detectors, on identical PPGs.

The PPGs are made by the JAX package's replay engine and carried across
with ``repro_torch.convert.from_reference`` (JSON + numpy trees), so
both packages see the same data.  Covered: the host-stacked path (an
unsharded ``PerfStore``), the sharded path (``TorchShardView`` on the
CPU), degraded fleets (``proc_mask``), float32, and the port's own
replay engine, which must reproduce the JAX package's bit for bit.
"""
import numpy as np
import pytest

from repro.core import COMM, COMP, PSG
from repro.core import detect_abnormal as ref_abnormal
from repro.core import detect_non_scalable as ref_non_scalable
from repro.core.inject import simulate as ref_simulate
from repro_torch.convert import from_reference
from repro_torch.core import ShardedStore, detect_abnormal, \
    detect_non_scalable
from repro_torch.core.graph import PSG as TorchPSG
from repro_torch.core.inject import simulate

CPU = "cpu"


def _psg(n_procs, n_comp=6):
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


def _carry(ppg):
    return from_reference(ppg.psg.to_json(), ppg.perf.to_tree(),
                          ppg.comm.to_tree())


def _ab_key(ab):
    return [(a.proc, a.vid, a.time, a.typical) for a in ab]


def _ns_same(got, want, tol=1e-12):
    assert [d.vid for d in got] == [d.vid for d in want]
    for a, b in zip(got, want):
        assert abs(a.slope - b.slope) <= tol * max(abs(b.slope), 1.0)
        assert abs(a.share - b.share) <= tol * max(abs(b.share), 1.0)
        assert a.times.keys() == b.times.keys()
        for s in a.times:
            assert abs(a.times[s] - b.times[s]) <= \
                tol * max(abs(b.times[s]), 1.0)


CASES = [(12, 3, 0), (16, 4, 1), (9, 2, 2), (24, 5, 3)]


@pytest.mark.parametrize("n_procs,n_hosts,seed", CASES)
@pytest.mark.parametrize("sharded", [False, True])
def test_abnormal_torch_equals_reference_numpy(n_procs, n_hosts, seed,
                                               sharded):
    ppg = ref_simulate(_psg(n_procs), n_procs, _base,
                       inject={(4, 2): 0.5, (7 % n_procs, 3): 0.2},
                       seed=seed, shards=n_hosts if sharded else None).ppg
    port = _carry(ppg)
    assert isinstance(port.perf, ShardedStore) == sharded
    got = detect_abnormal(port, backend="torch", device=CPU)
    want = ref_abnormal(ppg, backend="numpy")
    assert got and _ab_key(got) == _ab_key(want)       # median exact too


@pytest.mark.parametrize("strategy", ["mean", "max", "p0", "var"])
@pytest.mark.parametrize("sharded", [False, True])
def test_non_scalable_torch_equals_reference_numpy(strategy, sharded):
    g = _psg(16)

    def t_at(p, vid, n):
        return 0.08 if vid == 3 else 0.4 / n + 0.001 * (p % 2)

    series = {n: ref_simulate(g, n, lambda p, v, n=n: t_at(p, v, n),
                              shards=min(4, n) if sharded else None).ppg
              for n in (4, 8, 16)}
    port = {n: _carry(p) for n, p in series.items()}
    got = detect_non_scalable(port, backend="torch", device=CPU,
                              strategy=strategy)
    want = ref_non_scalable(series, backend="numpy", strategy=strategy)
    assert got and got[0].vid == 3
    _ns_same(got, want)


def test_median_and_cluster_strategies_stay_on_numpy():
    g = _psg(8)
    series = {n: ref_simulate(g, n, _base).ppg for n in (4, 8)}
    port = {n: _carry(p) for n, p in series.items()}
    for strategy in ("median", "cluster"):
        _ns_same(detect_non_scalable(port, backend="torch", device=CPU,
                                     strategy=strategy, min_share=0.0),
                 ref_non_scalable(series, backend="numpy",
                                  strategy=strategy, min_share=0.0))


@pytest.mark.parametrize("sharded", [False, True])
def test_proc_mask_equals_reference_numpy(sharded):
    n_procs = 16
    ppg = ref_simulate(_psg(n_procs), n_procs, _base,
                       inject={(2, 2): 6.0, (9, 3): 6.0},
                       shards=4 if sharded else None).ppg
    port = _carry(ppg)
    for dead in [(8, 9, 10, 11), (3,), (0, 5, 15)]:
        mask = np.ones(n_procs, bool)
        mask[list(dead)] = False
        got = detect_abnormal(port, backend="torch", device=CPU,
                              proc_mask=mask)
        want = ref_abnormal(ppg, backend="numpy", proc_mask=mask)
        assert _ab_key(got) == _ab_key(want)
        assert all(mask[a.proc] for a in got)


def test_non_scalable_proc_mask_equals_reference_numpy():
    g = _psg(16)
    series = {n: ref_simulate(g, n, lambda p, v, n=n: _base(p, v) + 0.3 / n
                              + (0.05 if v == 2 else 0.0),
                              shards=4).ppg for n in (4, 8, 16)}
    port = {n: _carry(p) for n, p in series.items()}
    mask = np.ones(16, bool)
    mask[[1, 6]] = False
    _ns_same(detect_non_scalable(port, backend="torch", device=CPU,
                                 proc_mask=mask, min_share=0.0),
             ref_non_scalable(series, backend="numpy", proc_mask=mask,
                              min_share=0.0))


def test_float32_tracks_reference_within_1e4(monkeypatch):
    monkeypatch.setenv("SCALANA_DETECT_F32", "1")
    g = _psg(12)
    inject = {(5, 1): 0.4, (2, 3): 0.2, (8, 2): 0.1}
    ppg = ref_simulate(g, 12, lambda p, vid: 0.01, inject=inject,
                       shards=3).ppg
    got = detect_abnormal(_carry(ppg), backend="torch", device=CPU)
    want = ref_abnormal(ppg, backend="numpy")
    assert [(a.proc, a.vid) for a in got] == [(a.proc, a.vid) for a in want]
    for a, b in zip(got, want):
        assert np.isclose(a.typical, b.typical, rtol=1e-4, atol=1e-6)
    series = {n: ref_simulate(g, n, _base, shards=3).ppg for n in (6, 12)}
    ns = detect_non_scalable({n: _carry(p) for n, p in series.items()},
                             backend="torch", device=CPU, min_share=0.0)
    ns_ref = ref_non_scalable(series, backend="numpy", min_share=0.0)
    assert [d.vid for d in ns] == [d.vid for d in ns_ref]
    for a, b in zip(ns, ns_ref):
        assert np.isclose(a.slope, b.slope, rtol=1e-4, atol=1e-4)


def test_sharded_path_never_stacks_host_matrix(monkeypatch):
    ppg = ref_simulate(_psg(12), 12, _base, inject={(3, 2): 0.5},
                       shards=3).ppg
    port = _carry(ppg)
    want = ref_abnormal(ppg, backend="numpy")

    def boom(*a, **k):                                 # pragma: no cover
        raise AssertionError("stacked host matrix materialized")

    monkeypatch.setattr(ShardedStore, "time_matrix", boom)
    monkeypatch.setattr(ShardedStore, "var_matrix", boom)
    got = detect_abnormal(port, backend="torch", device=CPU)
    assert got[0].proc == 3 and got[0].vid == 2
    assert [(a.proc, a.vid) for a in got] == [(a.proc, a.vid) for a in want]


def test_backend_resolution():
    ppg = _carry(ref_simulate(_psg(8), 8, _base).ppg)
    with pytest.raises(ValueError, match="unknown detect backend"):
        detect_abnormal(ppg, backend="jax")
    assert _ab_key(detect_abnormal(ppg, backend="auto", device=CPU)) == \
        _ab_key(detect_abnormal(ppg, backend="numpy"))


@pytest.mark.parametrize("shards", [None, 3])
@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_port_simulate_is_bit_identical(shards, jitter):
    g = _psg(12)
    inject = {(4, 2): 0.5, (1, 7): 0.25}
    want = ref_simulate(g, 12, _base, inject=inject, jitter=jitter, seed=5,
                        shards=shards)
    got = simulate(TorchPSG.from_json(g.to_json()), 12, _base,
                   inject=inject, jitter=jitter, seed=5, shards=shards)
    assert got.clocks == want.clocks and got.sched == want.sched
    a, b = got.ppg, want.ppg
    np.testing.assert_array_equal(a.times_matrix(), b.times_matrix())
    np.testing.assert_array_equal(a.var_matrix(), b.var_matrix())
    assert a.perf.counter_names() == b.perf.counter_names()
    for name in b.perf.counter_names():
        for x, y in zip(a.perf.counter_columns(name),
                        b.perf.counter_columns(name)):
            np.testing.assert_array_equal(x, y)
    for vid in range(len(g.vertices)):
        assert a.comm.groups_of(vid) == b.comm.groups_of(vid)
    assert sorted(a.comm.p2p_edges()) == sorted(b.comm.p2p_edges())
    assert a.meta == b.meta


def test_from_reference_round_trips_the_store():
    ppg = ref_simulate(_psg(10), 10, _base, shards=[(0, 3), (3, 10)]).ppg
    port = _carry(ppg)
    assert [(s.proc_start, s.n_procs) for s in port.perf.shards] == \
        [(0, 3), (3, 7)]
    np.testing.assert_array_equal(port.times_matrix(), ppg.times_matrix())
    assert port.psg.to_json() == ppg.psg.to_json()
    assert len(port.comm) == len(ppg.comm)

"""The port's run store, cross-run diff and checkpoint store against the
JAX package's, on the CPU.

* checkpoints: plain trees saved by either package load in the other
  (the manifests byte-identical), keep-N and async saves, and a
  non-plain tree (a torch tensor leaf) refused with ``TypeError``;
* the run store: runs recorded by ``repro.runs.RunStore`` load in the
  port's and the other way round — PPG, curves, clustering, detect
  output and metadata;
* ``diff_runs``: the port on ``backend="torch", device="cpu"`` (the torch
  ``fit_slopes``) and on ``"numpy"`` gives the reference's regressions,
  flags and times, slopes within 1e-12, and the same regression report;
* ``fit_slopes``: the torch twin within 1e-12 relative of
  ``repro.core.detect.fit_slopes`` in float64 and 1e-4 in float32;
* alignment and clustering equal to the reference's; the Monitor's
  ``archive_to`` readable by the reference.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.checkpoint.store as RC
import repro.runs as R
import repro_torch.checkpoint.store as TC
import repro_torch.runs as T
from repro.core.detect import Abnormal as RefAbnormal
from repro.core.detect import NonScalable as RefNonScalable
from repro.core.detect import fit_slopes as ref_fit_slopes
from repro.core.inject import simulate as ref_simulate
from repro.scenarios import bank as ref_bank
from repro.scenarios.faults import SerialFraction as RefSerialFraction
from repro_torch.convert import from_reference
from repro_torch.core.detect_torch import fit_slopes
from repro_torch.core.inject import simulate
from repro_torch.scenarios import bank
from repro_torch.scenarios.faults import SerialFraction

CPU = dict(backend="torch", device="cpu")


def _tree_equal(a, b, path=""):
    if isinstance(a, (dict, list)) or isinstance(b, (dict, list)):
        assert type(a) is type(b), path
        if isinstance(a, list):
            assert a == b == [], path
            return
        assert sorted(a) == sorted(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
        return
    aa, bb = np.asarray(a), np.asarray(b)
    assert aa.dtype == bb.dtype and np.array_equal(aa, bb), path


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

TREES = [
    pytest.param({"a": np.arange(6, dtype=np.int64).reshape(2, 3),
                  "b": {"c": np.float32(1.5), "d": np.zeros(0)},
                  "e": [np.ones(3, bool), np.array([1.25, -2.0])],
                  "f": 7, "g": 0.5, "h": True}, id="mixed"),
    pytest.param({"a": {}, "b": [], "c": {"d": np.arange(3), "e": {}}},
                 id="empty-containers"),
    pytest.param({}, id="empty"),
]


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("writer,reader", [(RC, TC), (TC, RC)],
                         ids=["ref-to-port", "port-to-ref"])
def test_plain_checkpoints_cross_both_ways(tree, writer, reader, tmp_path):
    meta = {"ranges": [[0, 4], [4, 8]], "note": "x"}
    writer.save_checkpoint(str(tmp_path / "w"), 3, tree, extra_meta=meta)
    got, got_meta = reader.load_checkpoint_tree(str(tmp_path / "w"), 3)
    want, want_meta = writer.load_checkpoint_tree(str(tmp_path / "w"), 3)
    _tree_equal(got, want)
    assert got_meta == want_meta == meta
    assert reader.latest_step(str(tmp_path / "w")) == 3
    # the other package writes the same manifest for the same tree
    reader.save_checkpoint(str(tmp_path / "r"), 3, tree, extra_meta=meta)
    manifests = [open(os.path.join(tmp_path, d, "step_3",
                                   "manifest.json")).read()
                 for d in ("w", "r")]
    assert manifests[0] == manifests[1]
    if tree and not isinstance(tree.get("a"), dict):
        like, _ = reader.load_checkpoint(str(tmp_path / "w"), 3, tree)
        _tree_equal(like["b"], want["b"])


def test_non_plain_trees_are_refused(tmp_path):
    tree = {"w": torch.ones(2)}
    with pytest.raises(TypeError, match="non-plain"):
        TC.save_checkpoint(str(tmp_path), 0, tree)
    assert not os.path.exists(tmp_path / "step_0.tmp")
    with pytest.raises(TypeError, match="non-plain"):
        TC.CheckpointManager(str(tmp_path)).save(0, tree, blocking=True)
    TC.save_checkpoint(str(tmp_path), 1, {"w": np.ones(2)})
    with pytest.raises(TypeError, match="non-plain"):
        TC.load_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="contains '/'"):
        TC.save_checkpoint(str(tmp_path), 2, {"a/b": np.zeros(2)})


def test_manager_keeps_n_and_saves_async(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save(step, {"x": np.full(3, step)}, blocking=step % 2 == 0)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    step, tree, _ = mgr.restore_latest({"x": np.zeros(3)})
    assert step == 3 and tree["x"].tolist() == [3, 3, 3]
    # the reference's manager reads the same directory
    assert RC.CheckpointManager(str(tmp_path)).latest_step() == 3


# ---------------------------------------------------------------------------
# the run store, both ways
# ---------------------------------------------------------------------------

def _series_pair(mod_bank, fault, n=32, scales=None,
                 scenario="amdahl_serial_fraction"):
    sc = mod_bank.get_scenario(scenario)
    psg, plan, trace = sc.build(n)
    scales = scales or [n // 4, n // 2, n]
    bad = mod_bank.simulate_series(psg, scales, plan.time_at_scale,
                                   inject=plan.inject, seed=sc.seed)
    clean = fault(frac=0.0).plan(trace, psg, n, sc.seed)
    good = mod_bank.simulate_series(psg, scales, clean.time_at_scale,
                                    inject=clean.inject, seed=sc.seed)
    return good, bad, plan


def _ppg_pair(mod_bank, fault, sim, n=64, scenario="serving_batch_skew"):
    sc = mod_bank.get_scenario(scenario)
    psg, plan, trace = sc.build(n)
    clean = fault(frac=0.0).plan(trace, psg, n, sc.seed)
    bad = sim(psg, n, plan.base_fn, inject=plan.inject, seed=sc.seed).ppg
    good = sim(psg, n, clean.base_fn, inject=clean.inject,
               seed=sc.seed).ppg
    return good, bad, plan


def _same_record(a, b):
    assert a.run_id == b.run_id and a.meta == b.meta
    assert a.psg.to_json() == b.psg.to_json()
    np.testing.assert_array_equal(a.ppg.times_matrix(), b.ppg.times_matrix())
    np.testing.assert_array_equal(a.ppg.var_matrix(), b.ppg.var_matrix())
    _tree_equal(a.ppg.comm.to_tree()[0], b.ppg.comm.to_tree()[0])
    for x, y in ((a.curves, b.curves), (a.scales, b.scales)):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert (a.clustering is None) == (b.clustering is None)
    if a.clustering is not None:
        for f in ("membership", "rep_procs", "counts"):
            assert np.array_equal(getattr(a.clustering, f),
                                  getattr(b.clustering, f))
        assert a.clustering.n_procs == b.clustering.n_procs
    assert (a.detect is None) == (b.detect is None)
    if a.detect is not None:
        assert sorted(a.detect) == sorted(b.detect)
        for k in a.detect:
            assert [vars(x) for x in a.detect[k]] \
                == [vars(x) for x in b.detect[k]]


def test_reference_runs_load_in_the_port(tmp_path):
    good, bad, _ = _series_pair(ref_bank, RefSerialFraction)
    ref = R.RunStore(str(tmp_path))
    detect = {"non_scalable": [RefNonScalable(
                  vid=3, slope=-0.1, share=0.5, score=1.0,
                  times={8: 0.2, 32: 0.19}, kind="Comp", name="x",
                  source="x.py:1")],
              "abnormal": [RefAbnormal(vid=2, proc=7, time=0.5, typical=0.1,
                                       ratio=5.0, kind="Comp", name="y")]}
    ids = [ref.record(series=bad, detect=detect, meta={"label": "nightly"}),
           ref.record(ppg=bad[32], cluster=4),
           ref.record(ppg=good[32])]
    port = T.RunStore(str(tmp_path))
    assert port.runs() == ids and port.latest().run_id == ids[-1]
    for rid in ids:
        _same_record(port.load(rid), ref.load(rid))
    # the port appends after the reference's runs, in the same directory
    nxt = port.record(ppg=port.load(ids[0]).ppg)
    assert nxt == "run_000003" and ref.runs() == ids + [nxt]
    _same_record(ref.load(nxt), port.load(nxt))


def test_port_runs_load_in_the_reference(tmp_path):
    good, bad, _ = _series_pair(bank, SerialFraction)
    port = T.RunStore(str(tmp_path))
    ids = [port.record(series=bad, meta={"label": "port"}),
           port.record(ppg=good[32], cluster=3)]
    ref = R.RunStore(str(tmp_path))
    for rid in ids:
        _same_record(port.load(rid), ref.load(rid))


# ---------------------------------------------------------------------------
# diff_runs: the torch slope fit against the reference
# ---------------------------------------------------------------------------

def _record_pair(tmp_path, case):
    """The same two runs recorded by the reference; returns the reference
    records and the port's loads of the same directories."""
    ref = R.RunStore(str(tmp_path))
    if case == "series":
        good, bad, _ = _series_pair(ref_bank, RefSerialFraction)
        ids = [ref.record(series=good), ref.record(series=bad)]
    elif case == "clean-vs-clean":
        good, _, _ = _series_pair(ref_bank, RefSerialFraction)
        ids = [ref.record(series=good), ref.record(series=good)]
    elif case == "scales-differ":
        good16, _, _ = _series_pair(ref_bank, RefSerialFraction, n=16,
                                    scales=[8, 16])
        _, bad32, _ = _series_pair(ref_bank, RefSerialFraction, n=32,
                                   scales=[16, 32])
        ids = [ref.record(series=good16), ref.record(series=bad32)]
    elif case == "peak":
        good, bad, _ = _ppg_pair(ref_bank, RefSerialFraction, ref_simulate)
        ids = [ref.record(ppg=good), ref.record(ppg=bad)]
    else:                                             # clustered
        good, bad, _ = _ppg_pair(ref_bank, RefSerialFraction, ref_simulate)
        ids = [ref.record(ppg=good, cluster=16),
               ref.record(ppg=bad, cluster=16)]
    port = T.RunStore(str(tmp_path))
    return ([ref.load(i) for i in ids], [port.load(i) for i in ids])


def _delta_key(d):
    return (d.vid_base, d.vid_cand, d.kind, d.name, d.source, d.base_time,
            d.cand_time, d.ratio, d.share, d.base_peak, d.cand_peak,
            d.peak_ratio, d.regressed, d.score)


@pytest.mark.parametrize("case", ["series", "clean-vs-clean",
                                  "scales-differ", "peak", "clustered"])
def test_diff_runs_equals_the_reference(case, tmp_path):
    (ra, rb), (pa, pb) = _record_pair(tmp_path, case)
    want = R.diff_runs(ra, rb, backend="numpy")
    for bk in (CPU, dict(backend="numpy")):
        got = T.diff_runs(pa, pb, **bk)
        assert got.backend == bk["backend"]
        assert got.regressed_vids == want.regressed_vids
        assert [_delta_key(d) for d in got.deltas] \
            == [_delta_key(d) for d in want.deltas]
        for g, w in zip(got.deltas, want.deltas):
            for x, y in ((g.base_slope, w.base_slope),
                         (g.cand_slope, w.cand_slope),
                         (g.slope_delta, w.slope_delta)):
                assert abs(x - y) <= 1e-12 * max(abs(y), 1.0)
        assert (got.added, got.removed, got.base_scale, got.cand_scale) \
            == (want.added, want.removed, want.base_scale, want.cand_scale)
        text = T.render_regression_report(pa, pb, got)
        ref_text = R.render_regression_report(ra, rb, want)
        assert text.replace(f"slope backend: {got.backend}",
                            "slope backend: numpy") == ref_text
        assert T.regressed_cluster(pb, got) == R.regressed_cluster(rb, want)
    if case == "clean-vs-clean":
        assert not want.regressions
    elif case != "scales-differ":
        assert want.regressions


# ---------------------------------------------------------------------------
# fit_slopes
# ---------------------------------------------------------------------------

def _curves(seed, S=5, V=300):
    rng = np.random.default_rng(seed)
    scales = np.asarray([2 ** (3 + i) for i in range(S)])
    M = rng.uniform(1e-4, 3.0, (S, V)) * scales[:, None] ** \
        rng.uniform(-1.2, 0.3, (1, V))
    M[rng.random((S, V)) < 0.2] = 0.0
    M[:, :3] = 0.0                       # no valid point
    M[:-1, 3] = 0.0                      # one valid point
    M[:, 4] = 1.0                        # flat: slope 0
    return scales, M


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("f32", [False, True])
def test_fit_slopes_matches_the_numpy_oracle(seed, f32, monkeypatch):
    if f32:
        monkeypatch.setenv("SCALANA_DETECT_F32", "1")
    scales, M = _curves(seed)
    valid = M > 0.0
    want = ref_fit_slopes(scales, M, valid)
    got = fit_slopes(scales, M, valid, device="cpu")
    assert got.dtype == (np.float32 if f32 else np.float64)
    assert got.shape == want.shape
    tol = 1e-4 if f32 else 1e-12
    assert np.all(np.abs(got - want) <= tol * np.maximum(np.abs(want), 1.0))
    assert (got[:4] == 0.0).all() and want[:4].tolist() == [0.0] * 4
    # one scale twice: every denominator is exactly zero -> slope 0
    flat = fit_slopes([8, 8], M[:2], valid[:2], device="cpu")
    assert (flat == 0.0).all()
    assert (ref_fit_slopes([8, 8], M[:2], valid[:2]) == 0.0).all()


# ---------------------------------------------------------------------------
# alignment, clustering, the Monitor's archive
# ---------------------------------------------------------------------------

def test_align_and_cluster_equal_the_reference():
    good, bad, _ = _ppg_pair(ref_bank, RefSerialFraction, ref_simulate)
    port_bad = from_reference(bad.psg.to_json(), bad.perf.to_tree(),
                              bad.comm.to_tree())
    port_good = from_reference(good.psg.to_json(), good.perf.to_tree(),
                               good.comm.to_tree())
    got = T.align_psgs(port_good.psg, port_bad.psg)
    want = R.align_psgs(good.psg, bad.psg)
    assert (got.pairs, got.a_only, got.b_only) \
        == (want.pairs, want.a_only, want.b_only)
    for k in (4, 16):
        a = T.cluster_procs(port_bad, max_clusters=k)
        b = R.cluster_procs(bad, max_clusters=k)
        assert np.array_equal(a.membership, b.membership)
        assert np.array_equal(a.rep_procs, b.rep_procs)
        assert a.max_center_dist == b.max_center_dist
        np.testing.assert_array_equal(
            T.behavior_matrix(port_bad), R.behavior_matrix(bad))
        np.testing.assert_array_equal(
            T.representative_ppg(port_bad, a).times_matrix(),
            R.representative_ppg(bad, b).times_matrix())
    # the port's own replay gives the same run to diff
    sc = bank.get_scenario("serving_batch_skew")
    psg, plan, _ = sc.build(64)
    mine = simulate(psg, 64, plan.base_fn, inject=plan.inject,
                    seed=sc.seed).ppg
    np.testing.assert_array_equal(mine.times_matrix(), bad.times_matrix())


def test_monitor_archive_loads_in_the_reference(tmp_path):
    import repro_torch.monitor as TM
    from repro_torch.core.shard import ShardedStore, shard_ranges
    psg = TM.build_chaos_psg(6)
    ranges = shard_ranges(12, 3)
    truth = simulate(psg, 12,
                     lambda p, v: 0.0 if psg.vertices[v].kind == "Comm"
                     else 1.0 + 0.01 * v,
                     inject={(5, 2): 3.0}, comm_time=lambda *a: 0.05,
                     jitter=0.0, seed=0, shards=ranges).ppg
    tr = TM.QueueTransport()
    mon = TM.Monitor(psg, ranges, tr, comm=truth.comm, detect_every=1, **CPU)
    prod = ShardedStore(ranges, len(psg.vertices))
    for h in range(3):
        sh = prod.shards[h]
        sh.apply_rows(truth.perf.shards[h].extract_rows(
            np.arange(sh.n_procs)))
        TM.ShardProducer(h, sh, tr, sleep=lambda s: None).flush(
            heartbeat=False)
    mon.poll()
    rid = mon.archive_to(T.RunStore(str(tmp_path)), meta={"label": "live"})
    rec = R.RunStore(str(tmp_path)).load(rid)
    assert rec.scale == 12 and rec.meta["label"] == "live"
    assert rec.meta["applied"] == 3
    assert np.array_equal(np.asarray(rec.ppg.times_matrix()),
                          mon.store.time_matrix(len(psg.vertices)))
    assert [(a.vid, a.proc, a.time) for a in rec.detect["abnormal"]] \
        == [(a.vid, a.proc, a.time) for a in mon.reports[-1].abnormal]
    assert json.loads(json.dumps(rec.meta)) == rec.meta

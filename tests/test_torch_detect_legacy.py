"""The port's unfused legacy detection chain (``fused=False``) against its
fused ops and the JAX package's numpy detectors.

The JAX package's own legacy chain (``detect_jax``'s jitted ``jnp``)
cannot run on the installed jax (``detect_jax.HAS_JAX`` is False there),
so the chain is held, as the ROADMAP's reference caveat prescribes,
against ``repro.core.detect(backend="numpy")`` on the same PPGs (made by
the JAX package's replay engine and carried across with
``repro_torch.convert.from_reference``) and against the port's fused
path: slopes within 1e-12 in float64 and 1e-4 in float32, flags and
top-k orders exact, also after a 16-row dirty write; the fused launch
counters stay at 0 on the legacy path.
"""
import numpy as np
import pytest

from repro.core import COMP, PSG
from repro.core import detect_abnormal as ref_abnormal
from repro.core import detect_non_scalable as ref_non_scalable
from repro.core.inject import simulate as ref_simulate
from repro_torch.convert import from_reference
from repro_torch.core import detect_torch
from repro_torch.core.detect import _merge_matrix
from repro_torch.kernels.detect_fused import kernel, ops

CPU = "cpu"
NS = dict(ideal_slope=0.0, slope_margin=0.05, min_share=0.0,
          strategy="mean")
AB = dict(abnorm_thd=1.5, min_share=0.001, k=8)
TOL = {"f64": 1e-12, "f32": 1e-4}


def _step_psg(n_comp=8):
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
    return g


def _series(seed, scales=(4, 8, 32), n_hosts=4):
    """A sharded series with seeded noise, one vertex whose time grows
    with the scale (non-scalable) and one straggler entry."""
    g = _step_psg()
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0.0, 0.004, (max(scales), len(g.vertices)))
    p, vid = int(rng.integers(0, max(scales))), int(rng.integers(1, 8))

    def base(proc, v, n):
        extra = 0.06 if (proc, v) == (p, vid) else 0.0
        grow = 0.0005 * n if v == 3 else 0.0
        return 0.01 * (1 + proc % 3) + 0.001 * v + noise[proc, v] \
            + 0.02 / n + grow + extra

    ref = {n: ref_simulate(g, n, lambda pr, v, n=n: base(pr, v, n),
                           shards=min(n_hosts, n)).ppg for n in scales}
    port = {n: from_reference(x.psg.to_json(), x.perf.to_tree(),
                              x.comm.to_tree()) for n, x in ref.items()}
    return ref, port


def _ns(views, scales, V, top, fused):
    present = np.ones((len(scales), V), bool)
    return detect_torch.non_scalable_views(
        scales, views, V, present, top, NS["ideal_slope"],
        NS["slope_margin"], NS["min_share"], NS["strategy"], fused=fused)


def _ab(view, V, top, fused, live_rows=None):
    return detect_torch.abnormal_topk_view(
        view, V, top, AB["abnorm_thd"], AB["min_share"], AB["k"],
        live_rows=live_rows, fused=fused)


def _check_cycle(ref, port, tol, uploaded=None):
    scales = sorted(port)
    live = port[scales[-1]]
    V = len(live.psg.vertices)
    top = live.psg.children(live.psg.root)
    views = [port[n].device_view(CPU) for n in scales]
    launches = [v.kernel_launches for v in views]

    ops.reset_launch_counts()
    kernel.reset_launches()
    legacy_ns = _ns(views, scales, V, top, fused=False)
    if uploaded is not None:                  # the dirty rows, no more
        assert views[-1].last_upload_rows == uploaded
    legacy_ab = _ab(views[-1], V, top, fused=False)
    assert not any(ops.launch_counts.values())
    assert [v.kernel_launches for v in views] == launches
    fused_ns = _ns(views, scales, V, top, fused=True)
    fused_ab = _ab(views[-1], V, top, fused=True)
    assert ops.launch_counts["non_scalable_live"] == 1
    assert ops.launch_counts["abnormal"] == 1

    # legacy == fused: flags and orders exact, floats within tol
    np.testing.assert_array_equal(legacy_ns[3], fused_ns[3])
    for a, b in zip(legacy_ns[:3], fused_ns[:3]):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    for a, b in zip(legacy_ab[:2], fused_ab[:2]):
        np.testing.assert_array_equal(a, b)
    assert legacy_ab[3] == fused_ab[3]
    np.testing.assert_allclose(legacy_ab[2], fused_ab[2], rtol=tol,
                               atol=tol)

    # legacy == the JAX package's numpy detectors
    want = ref_non_scalable(ref, backend="numpy", top_k=V, **NS)
    assert want                           # the straggler's vertex at least
    assert sorted(np.flatnonzero(legacy_ns[3])) == sorted(d.vid
                                                          for d in want)
    for d in want:
        assert abs(legacy_ns[1][d.vid] - d.slope) <= tol * max(
            abs(d.slope), 1.0)
    want_ab = ref_abnormal(ref[scales[-1]], backend="numpy",
                           abnorm_thd=AB["abnorm_thd"],
                           min_share=AB["min_share"], top_k=AB["k"])
    assert list(zip(legacy_ab[1].tolist(), legacy_ab[0].tolist())) == \
        [(a.proc, a.vid) for a in want_ab]
    for a in want_ab:
        assert abs(legacy_ab[2][a.vid] - a.typical) <= tol * max(
            abs(a.typical), 1.0)
    return legacy_ab


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_legacy_equals_fused_equals_numpy(precision, seed, monkeypatch):
    if precision == "f32":
        monkeypatch.setenv("SCALANA_DETECT_F32", "1")
    ref, port = _series(seed)
    _check_cycle(ref, port, TOL[precision])


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_legacy_after_a_16_row_dirty_write(precision, monkeypatch):
    if precision == "f32":
        monkeypatch.setenv("SCALANA_DETECT_F32", "1")
    ref, port = _series(3)
    top_n = max(port)
    _check_cycle(ref, port, TOL[precision])
    rows = np.sort(np.random.default_rng(4).choice(top_n, 16,
                                                   replace=False))
    for store in (ref[top_n].perf, port[top_n].perf):
        store.set_entries(rows, 5, 0.5)
    legacy_ab = _check_cycle(ref, port, TOL[precision], uploaded=16)
    assert {(int(p), int(v)) for v, p in zip(*legacy_ab[:2])} <= \
        {(int(r), 5) for r in rows}
    assert len(legacy_ab[0]) == AB["k"]


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_legacy_degraded_fleet_equals_fused(precision, monkeypatch):
    if precision == "f32":
        monkeypatch.setenv("SCALANA_DETECT_F32", "1")
    ref, port = _series(5)
    live = port[max(port)]
    V = len(live.psg.vertices)
    top = live.psg.children(live.psg.root)
    rows = np.arange(1, live.n_procs - 2)
    view = live.device_view(CPU)
    ops.reset_launch_counts()
    got = _ab(view, V, top, fused=False, live_rows=rows)
    assert not any(ops.launch_counts.values())
    want = _ab(view, V, top, fused=True, live_rows=rows)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    mask = np.zeros(live.n_procs, bool)
    mask[rows] = True
    want_np = ref_abnormal(ref[max(ref)], backend="numpy", proc_mask=mask,
                           abnorm_thd=AB["abnorm_thd"],
                           min_share=AB["min_share"], top_k=AB["k"])
    assert [(int(rows[p]), int(v)) for v, p in zip(*got[:2])] == \
        [(a.proc, a.vid) for a in want_np]


@pytest.mark.parametrize("strategy", ["mean", "max", "p0", "var"])
def test_merge_matrix_equals_numpy(strategy):
    rng = np.random.default_rng(7)
    t = rng.uniform(0, 2, (37, 11))
    t[t < 0.3] = 0.0
    var = rng.uniform(0, 0.1, t.shape)
    got = detect_torch.merge_matrix(t, strategy, var=var, device=CPU)
    want = _merge_matrix(t, strategy, var=var)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_abnormal_arrays_equal_numpy_flags():
    rng = np.random.default_rng(8)
    t = rng.uniform(0.01, 0.02, (33, 9))
    t[4, 2] = 0.2
    t[17, 6] = 0.09
    step = float(t.sum(axis=1).max())
    flags, typical = detect_torch.abnormal_arrays(t, 1.5, 0.001, step,
                                                  device=CPU)
    np.testing.assert_array_equal(typical, np.median(t, axis=0))
    over = (typical > 0) & (t > 1.5 * typical) & \
        ((t - typical) / step >= 0.001)
    np.testing.assert_array_equal(flags, over & (t.max(axis=0) > 0))
    assert flags[4, 2] and flags[17, 6]

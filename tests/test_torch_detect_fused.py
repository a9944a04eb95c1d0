"""The port's fused detection ops against the JAX package's.

Same seeded numpy inputs through three implementations:

* the port's ops (``repro_torch.kernels.detect_fused.ops``) on CPU
  tensors, which run the plain torch versions of the CUDA kernels;
* the JAX package's fused ops in Pallas interpret mode — float64 under
  ``jax.enable_x64(True)``, and float32;
* the JAX package's numpy oracle (``repro.kernels.detect_fused.ref``).

Order, count and typical are exact; floats agree to 1e-12 in float64
(reductions run in another order) and 1e-4 in float32.  The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``, which skips where
there is no card.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.detect_fused import ops as jops  # noqa: E402
from repro.kernels.detect_fused import ref as nref  # noqa: E402
from repro_torch.kernels.detect_fused import ops, ref  # noqa: E402

ARGS = dict(ideal_slope=0.0, slope_margin=0.05, min_share=0.01)
TOL = {np.float64: 1e-12, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]


def _case(seed=0, S=3, P=37, V=11, dtype=np.float64, grid=None):
    """Random stacked detection inputs with dead readings and absent
    vertices, shapes off any tile size; ``grid`` rounds the times so
    scores tie."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2, (S, P, V))
    if grid:
        t = np.round(t / grid) * grid
    t[t < 0.3] = 0.0
    var = rng.uniform(0, 0.1, (S, P, V))
    present = rng.random((S, V)) > 0.1
    scales = [P // 4, P // 2, P][-S:]
    top = np.array([2, 7, 3], np.int32) % V
    return t.astype(dtype), var.astype(dtype), present, scales, top


def _jax(dtype):
    """Context for the JAX ops: x64 for float64, default for float32."""
    return jax.enable_x64(dtype == np.float64)


def _tt(a, dtype=None):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a if dtype is None else a.astype(dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# non-scalable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("in_kernel_total", [False, True])
def test_ns_stacked_matches_jax_and_oracle(dtype, in_kernel_total):
    t, var, present, scales, top = _case(seed=0, dtype=dtype)
    total = None if in_kernel_total else float(
        t[-1].astype(np.float64)[:, top].max(axis=0, initial=0.0).sum())
    logp = np.log(np.asarray(scales, dtype))
    got = ops.fused_non_scalable(
        _tt(t), _tt(var), _tt(logp), _tt(present), total_max=total,
        top_idx=_tt(top), **ARGS)
    with _jax(dtype):
        want = jops.fused_non_scalable(
            jnp.asarray(t), jnp.asarray(var), jnp.asarray(logp),
            jnp.asarray(present), total_max=total, top_idx=jnp.asarray(top),
            interpret=True, **ARGS)
    oracle = nref.non_scalable_ref(
        scales, t.astype(np.float64), var.astype(np.float64), present,
        total_max=total, top=None if total is not None else top, **ARGS)
    for g, w, o in zip(got[:3], want[:3], oracle[:3]):
        _close(g, w, dtype)
        _close(g, o, dtype)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[3].numpy(), oracle[3])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ns_live_blocks_plus_hist_matches_jax_and_oracle(dtype):
    """Steady-state shape: the live scale as blocks plus the historical
    merged columns spliced in front — the full stacked answer."""
    t, var, present, scales, top = _case(seed=1, dtype=dtype)
    hist = nref.merge_all_ref(t[:-1], var[:-1]).astype(dtype)
    cuts = [t.shape[1] // 3, 2 * t.shape[1] // 3]
    logp = np.log(np.asarray(scales, dtype))
    got = ops.fused_non_scalable_live(
        [_tt(b) for b in np.split(t[-1], cuts, axis=0)],
        [_tt(b) for b in np.split(var[-1], cuts, axis=0)],
        _tt(hist), _tt(logp), _tt(present), _tt(top), **ARGS)
    with _jax(dtype):
        want = jops.fused_non_scalable_live(
            [jnp.asarray(b) for b in np.split(t[-1], cuts, axis=0)],
            [jnp.asarray(b) for b in np.split(var[-1], cuts, axis=0)],
            jnp.asarray(hist), jnp.asarray(logp), jnp.asarray(present),
            jnp.asarray(top), interpret=True, **ARGS)
    oracle = nref.non_scalable_ref(scales, t.astype(np.float64),
                                   var.astype(np.float64), present,
                                   top=top, **ARGS)
    for g, w, o in zip(got[:3], want[:3], oracle[:3]):
        _close(g, w, dtype)
        _close(g, o, dtype)
    np.testing.assert_array_equal(got[3].numpy(), oracle[3])


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_scale_column_matches_jax_and_oracle(dtype):
    t, var, _, _, _ = _case(seed=2, dtype=dtype)
    cuts = [5, 30]
    got = ops.merge_scale_column(
        [_tt(b) for b in np.split(t[0], cuts, axis=0)],
        [_tt(b) for b in np.split(var[0], cuts, axis=0)])
    with _jax(dtype):
        want = jops.merge_scale_column(
            [jnp.asarray(b) for b in np.split(t[0], cuts, axis=0)],
            [jnp.asarray(b) for b in np.split(var[0], cuts, axis=0)])
    oracle = nref.merge_all_ref(t[:1].astype(np.float64),
                                var[:1].astype(np.float64))[:, 0]
    assert tuple(got.shape) == (4, t.shape[2])
    _close(got, want, dtype)
    _close(got, oracle, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_dead_final_scale_keeps_finite(dtype):
    """An all-dead final scale: the oracle's p0/mean fallbacks, share 0,
    no flags — never inf/nan."""
    t, var, present, scales, top = _case(seed=7, dtype=dtype)
    t[-1] = 0.0
    logp = np.log(np.asarray(scales, dtype))
    M, sl, sh, fl = ops.fused_non_scalable(
        _tt(t), _tt(var), _tt(logp), _tt(present), top_idx=_tt(top),
        **ARGS)
    Mr, slr, shr, flr = nref.non_scalable_ref(
        scales, t.astype(np.float64), var.astype(np.float64), present,
        top=top, **ARGS)
    assert torch.isfinite(M).all() and torch.isfinite(sl).all()
    _close(M, Mr, dtype)
    _close(sh, shr, dtype)
    assert not fl.any() and not flr.any()


# ---------------------------------------------------------------------------
# abnormal
# ---------------------------------------------------------------------------

def _ab_jax(blocks, top, k, dtype, **kw):
    with _jax(dtype):
        out = jops.fused_abnormal([jnp.asarray(b) for b in blocks],
                                  None if top is None else jnp.asarray(top),
                                  1.5, 0.001, k, interpret=True,
                                  **{n: (jnp.asarray(v) if n != "step_time"
                                         else v) for n, v in kw.items()})
    return [np.asarray(x) for x in out]


def _ab_port(blocks, top, k, **kw):
    out = ops.fused_abnormal([_tt(b) for b in blocks],
                             None if top is None else _tt(top), 1.5, 0.001,
                             k, **{n: (_tt(v) if n != "step_time" else v)
                                   for n, v in kw.items()})
    return [x.numpy() for x in out]


def _same_ab(got, want, dtype, exact_scores=True):
    np.testing.assert_array_equal(got[0], want[0])          # order
    assert int(got[2]) == int(want[2])                      # count
    if exact_scores:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[3], want[3])      # typical
    else:
        _close(got[3], want[3], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("step_time", [None, 3.25])
def test_ab_full_fleet_matches_jax_and_oracle(dtype, step_time):
    """Winners, scores, count and typical EXACT against the JAX fused op
    in the same precision; against the float64 oracle too in float64."""
    t, _, _, _, top = _case(seed=2, dtype=dtype)
    blocks = np.split(t[-1], [10, 20], axis=0)
    kw = {} if step_time is None else dict(step_time=step_time)
    got = _ab_port(blocks, top, 9, **kw)
    _same_ab(got, _ab_jax(blocks, top, 9, dtype, **kw), dtype)
    o, s, c, ty = nref.abnormal_ref(t[-1].astype(np.float64), top, 1.5,
                                    0.001, 9, step_time=step_time)
    np.testing.assert_array_equal(got[0], o)
    assert int(got[2]) == c
    if dtype == np.float64:
        np.testing.assert_array_equal(got[3], ty)
        np.testing.assert_array_equal(got[1], s)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ab_degraded_fleet_matches_jax_and_oracle(dtype):
    """The padded live gather: dead rows excluded from median, step time,
    flags and ranking — numpy row-subset semantics."""
    t, _, _, _, top = _case(seed=4, dtype=dtype)
    P, k = t.shape[1], 7
    rng = np.random.default_rng(5)
    live = np.sort(rng.choice(P, size=P - 9, replace=False))
    lpad = np.zeros(P, np.int64)
    lpad[:live.size] = live
    vmask = np.zeros(P, bool)
    vmask[:live.size] = True
    blocks = np.split(t[-1], [10, 20], axis=0)
    got = _ab_port(blocks, top, k, live=lpad, valid=vmask)
    _same_ab(got, _ab_jax(blocks, top, k, dtype, live=lpad.astype(np.int32),
                          valid=vmask), dtype)
    o, _, c, ty = nref.abnormal_ref(t[-1].astype(np.float64)[lpad], top,
                                    1.5, 0.001, k, valid=vmask)
    np.testing.assert_array_equal(got[0], o)
    assert int(got[2]) == c
    if dtype == np.float64:
        np.testing.assert_array_equal(got[3], ty)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ab_tied_scores_rank_by_ascending_index(dtype):
    """Times on a coarse grid: many equal scores, ranked by ascending
    vid-major index exactly as the stable argsort ranks them."""
    t, _, _, _, top = _case(seed=9, P=64, V=6, dtype=dtype, grid=0.25)
    got = _ab_port([t[-1]], top, 40)
    _same_ab(got, _ab_jax([t[-1]], top, 40, dtype), dtype)
    o, _, c, _ = nref.abnormal_ref(t[-1].astype(np.float64), top, 1.5,
                                   0.001, 40)
    np.testing.assert_array_equal(got[0], o)
    scores = got[1][:min(40, c)]
    assert len(set(scores.tolist())) < len(scores)          # ties present


@pytest.mark.parametrize("dtype", DTYPES)
def test_ab_empty_flag_set_fills_neg_inf_tail(dtype):
    """A uniform fleet flags nothing: count 0, every slot holds the -inf
    tail in ascending vid-major order."""
    t = np.full((8, 5), 0.25, dtype)
    top = np.array([0, 1], np.int32)
    got = _ab_port([t], top, 4)
    _same_ab(got, _ab_jax([t], top, 4, dtype), dtype)
    assert int(got[2]) == 0
    np.testing.assert_array_equal(got[0], [0, 1, 2, 3])
    assert np.isneginf(got[1]).all()
    np.testing.assert_array_equal(got[3], np.full(5, 0.25, dtype))


def test_ab_few_flags_then_tail():
    """Fewer flags than k: the flagged entries first, then the -inf tail
    in ascending index order, skipping the flagged ones."""
    t = np.full((6, 3), 0.25)
    t[4, 0] = 2.0
    t[1, 2] = 3.0
    got = _ab_port([t], np.array([0, 1, 2], np.int32), 5)
    o, s, c, _ = nref.abnormal_ref(t, [0, 1, 2], 1.5, 0.001, 5)
    np.testing.assert_array_equal(got[0], o)
    np.testing.assert_array_equal(got[1], s)
    assert int(got[2]) == c == 2
    np.testing.assert_array_equal(got[0][:2], [2 * 6 + 1, 0 * 6 + 4])
    np.testing.assert_array_equal(got[0][2:], [0, 1, 2])


def test_ab_k_zero_short_circuits_without_a_launch():
    ops.reset_launch_counts()
    o, s, c, ty = ops.fused_abnormal([torch.ones(4, 3, dtype=torch.float64)],
                                     None, 1.5, 0.001, 0, step_time=1.0)
    assert o.shape == (0,) and s.shape == (0,) and int(c) == 0
    assert ty.shape == (3,)
    assert ops.launch_counts["abnormal"] == 0


def test_launch_seam_counts_each_op_once():
    t, var, present, scales, top = _case(seed=3)
    seen = []
    ops.reset_launch_counts()
    ops.on_launch = seen.append
    try:
        ops.fused_abnormal([_tt(t[-1])], _tt(top), 1.5, 0.001, 3)
        ops.fused_non_scalable(_tt(t), _tt(var), _tt(np.log(scales)),
                               _tt(present), top_idx=_tt(top), **ARGS)
        ops.merge_scale_column([_tt(t[0])], [_tt(var[0])])
    finally:
        ops.on_launch = None
    assert seen == ["abnormal", "non_scalable", "merge_column"]
    assert dict(ops.launch_counts) == {"abnormal": 1, "non_scalable": 1,
                                       "merge_column": 1}


# ---------------------------------------------------------------------------
# the integer-key bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_keys_preserve_float_order_and_round_trip(dtype):
    x = torch.tensor([float("-inf"), -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0,
                      7.25, float("inf")], dtype=dtype)
    k = ref.to_key(x)
    assert torch.equal(ref.from_key(k, dtype).view(k.dtype), x.view(k.dtype))
    assert (k[1:] > k[:-1]).all()                  # -0.0 sorts below +0.0

"""The port's optimizer on the CPU against the JAX package's.

``adamw_update`` (with and without clipping, from a fresh and a warm
state), ``global_norm``, the three schedules and the error-feedback
compression, each on the same seeded numpy inputs through both
packages.  Tolerances: 1e-6 relative (float32 arithmetic in the same
order; the leaves are summed in ``jax.tree.leaves`` order by both), with
an absolute floor of 1e-6 of a leaf's largest magnitude for entries
near zero; the int8 codes of ``compress_leaf`` exactly, ties included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch.optim import adamw, compress, schedule
from repro_torch.optim.tree import leaves, tree_map, unflatten_like

RTOL = 1e-6


def _tree(rng, scale=1.0):
    """Nested params-like leaves; sizes off the 256-element blocks."""
    return {"embed": {"embedding": scale * rng.standard_normal((37, 16))},
            "layers": {"w": scale * rng.standard_normal((3, 16, 24)),
                       "norm": scale * rng.standard_normal((3, 16))},
            "final_norm": scale * rng.standard_normal((16,))}


def _np32(tree):
    return tree_map(lambda a: np.asarray(a, np.float32), tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


def _close_tree(got, want):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        _close(g.numpy(), w)


def test_tree_leaves_follow_jax_order():
    tree = _np32(_tree(np.random.default_rng(0)))
    for a, b in zip(leaves(tree), jax.tree.leaves(tree)):
        assert a is b
    assert unflatten_like(tree, leaves(tree)) == tree
    assert list(unflatten_like(tree, leaves(tree))) == list(tree)


def test_global_norm_matches():
    tree = _np32(_tree(np.random.default_rng(1)))
    _close(adamw.global_norm(_t(tree)).numpy(),
           jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "warm"])
@pytest.mark.parametrize("max_grad_norm", [1.0, 0.0], ids=["clip", "noclip"])
def test_adamw_update_matches(warm, max_grad_norm):
    rng = np.random.default_rng(2)
    params = _np32(_tree(rng))
    grads = _np32(_tree(rng, scale=0.3))
    if warm:     # moments from earlier steps: nu > 0, step 5
        mu = _np32(_tree(rng, scale=0.05))
        nu = tree_map(lambda a: np.abs(a) + np.float32(1e-3),
                      _np32(_tree(rng, scale=0.01)))
        step = 5
    else:
        mu = tree_map(np.zeros_like, params)
        nu = tree_map(np.zeros_like, params)
        step = 0
    jstate = jadamw.AdamWState(step=jnp.asarray(step, jnp.int32),
                               mu=jax.tree.map(jnp.asarray, mu),
                               nu=jax.tree.map(jnp.asarray, nu))
    tstate = adamw.AdamWState(step=torch.tensor(step, dtype=torch.int32),
                              mu=_t(mu), nu=_t(nu))
    jp, js, jm = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, grads), jstate,
        jax.tree.map(jnp.asarray, params), lr=jnp.float32(1e-3),
        max_grad_norm=max_grad_norm)
    tp, ts, tm = adamw.adamw_update(
        _t(grads), tstate, _t(params), lr=torch.tensor(1e-3),
        max_grad_norm=max_grad_norm)
    _close_tree(tp, jp)
    _close_tree(ts.mu, js.mu)
    _close_tree(ts.nu, js.nu)
    assert int(ts.step) == int(js.step) == step + 1
    assert list(tm) == list(jm) == ["grad_norm", "param_norm", "lr"]
    for k in tm:
        _close(tm[k].numpy(), jm[k])
        assert tm[k].dtype == torch.float32


def test_adamw_init_is_zeros_congruent_with_params():
    params = _t(_np32(_tree(np.random.default_rng(3))))
    st = adamw.adamw_init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for p, m, v in zip(leaves(params), leaves(st.mu), leaves(st.nu)):
        assert m.shape == p.shape == v.shape
        assert not m.any() and not v.any()


SCHEDULES = [("constant", (3e-4,)), ("warmup_linear", (3e-4, 100, 1000)),
             ("warmup_cosine", (3e-4, 100, 1000))]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match(name, args):
    jf = getattr(jschedule, name)(*args)
    tf = getattr(schedule, name)(*args)
    for step in (0, 1, 100, 101, 1000, 2000):
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        _close(got.numpy(), jf(jnp.asarray(step, jnp.int32)))
        _close(tf(step).numpy(), jf(step))


def test_compress_leaf_codes_exact_including_ties():
    rng = np.random.default_rng(4)
    # block 0: max |x| = 127 -> scale 1 exactly, so x itself is rounded:
    # exact .5 ties round to even in both packages
    ties = np.zeros(256, np.float32)
    ties[:9] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5, 4.5]
    x = np.concatenate([ties, rng.standard_normal(256 * 3 + 77),
                        np.zeros(256)]).astype(np.float32)
    jc, js = jcompress.compress_leaf(jnp.asarray(x))
    tc, ts = compress.compress_leaf(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert list(tc[0, :9]) == [127, 2, -4, 0, 0, 2, 126, -126, 4]
    _close(ts.numpy(), js)
    back = compress.decompress_leaf(tc, ts, x.shape)
    _close(back.numpy(), jcompress.decompress_leaf(jc, js, x.shape))


def test_compress_grads_roundtrip_matches():
    tree = _np32(_tree(np.random.default_rng(5)))
    jt = jax.tree.map(jnp.asarray, tree)
    tt = _t(tree)
    got = compress.decompress_grads(compress.compress_grads(tt), tt)
    want = jcompress.decompress_grads(jcompress.compress_grads(jt), jt)
    _close_tree(got, want)


def test_error_feedback_update_matches():
    rng = np.random.default_rng(6)
    grads = _np32(_tree(rng))
    residual = _np32(_tree(rng, scale=0.01))
    jg, jr = jcompress.error_feedback_update(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, residual))
    tg, tr = compress.error_feedback_update(_t(grads), _t(residual))
    _close_tree(tg, jg)
    _close_tree(tr, jr)
    for r in leaves(compress.init_residual(_t(grads))):
        assert r.dtype == torch.float32 and not r.any()

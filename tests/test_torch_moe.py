"""The port's MoE family on the CPU against the JAX package.

The MoE layer on seeded numpy inputs (routing, capacity, both dispatch
strategies, with and without dropped tokens), then the smoke-size
moonshot-v1-16b-a3b and dbrx-132b with the JAX parameters carried over by
``params_from_reference``: ``train_loss`` and its three MoE metrics by
einsum and by sort, ``prefill`` and eight ``decode_step`` s.

Tolerances: 1e-5 relative for float32 losses and the aux / z metrics (the
same products summed in another order by another BLAS), 1e-4 absolute
for logits and caches, 1e-5 for one layer's output; ``moe_drop_frac``
and the routing's expert choices exact (they count integers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model, moe

ARCHS = ["moonshot-v1-16b-a3b", "dbrx-132b"]
STRATEGIES = ["einsum", "sort"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer(arch, seed=0):
    """(JAX cfg, port cfg, one MoE layer's weights as numpy)."""
    cfg = jax_smoke(arch)
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2]))
         .astype(np.float32) for k, s in jmoe.moe_specs(cfg).items()}
    return cfg, get_smoke(arch), p


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


# -- the layer --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches(arch):
    cfg, tcfg, p = _layer(arch)
    x = _x(cfg, (40,))
    jw, je, jaux, jz = jmoe._routing(cfg, p, x)
    tw, te, taux, tz = moe._routing(tcfg, {k: _t(v) for k, v in p.items()},
                                    _t(x))
    assert te.tolist() == np.asarray(je).tolist()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-5)


def test_routing_breaks_ties_as_lax_top_k():
    """A zero router gives every expert the same probability: lax.top_k
    takes the lowest experts first, and so does the port."""
    cfg, tcfg, p = _layer("moonshot-v1-16b-a3b")
    p["router"][:] = 0.0
    p["router"][:, 5] = 1.0                      # one clear winner
    x = np.abs(_x(cfg, (6,)))
    _, je, _, _ = jmoe._routing(cfg, p, x)
    _, te, _, _ = moe._routing(tcfg, {k: _t(v) for k, v in p.items()},
                               _t(x))
    assert te.tolist() == np.asarray(je).tolist()
    assert te[:, 0].tolist() == [5] * 6 and te[:, 1].tolist() == [0] * 6


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches(arch):
    cfg, tcfg, _ = _layer(arch)
    for n in (1, 2, 3, 7, 16, 64, 1000, 1024):
        for cf in (0.5, moe.CAPACITY_FACTOR, moe.SERVE_CAPACITY_FACTOR):
            assert moe._capacity(tcfg, n, cf) == jmoe._capacity(cfg, n, cf)
    assert moe._capacity(tcfg, 1, moe.SERVE_CAPACITY_FACTOR) == 1


@pytest.mark.parametrize("cf", [0.5, moe.CAPACITY_FACTOR,
                                moe.SERVE_CAPACITY_FACTOR],
                         ids=["drops", "train", "serve"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches(arch, strategy, cf):
    cfg, tcfg, p = _layer(arch)
    cfg = cfg.replace(moe_group_size=16)         # 2 groups of 16 tokens a row
    tcfg = tcfg.replace(moe_group_size=16)
    x = _x(cfg, (2, 32))
    jy, jm = jmoe.moe_apply(cfg, p, x, strategy, cf)
    ty, tm = moe.moe_apply(tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
                           strategy, cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert float(tm["moe_drop_frac"]) == float(jm["moe_drop_frac"])
    if cf < 1.0:
        assert float(tm["moe_drop_frac"]) > 0.0   # the drop path ran
    for k in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)


# -- the model --------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, JAX params, port params), the same weights in both."""
    cfg = jax_smoke(request.param)
    jp = jax_build(cfg).init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _tokens(cfg, shape, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_train_loss_and_metrics_match_jax(pair, strategy):
    cfg, jp, tp = pair
    toks = _tokens(cfg, (2, 33))
    toks[1, -1] = -1                             # a masked label
    want, jmet = jax_build(cfg, moe_strategy=strategy).train_loss(
        jp, {"tokens": jnp.asarray(toks)})
    tm = build_model(get_smoke(cfg.name), device="cpu",
                     moe_strategy=strategy)
    got, met = tm.train_loss(tp, {"tokens": _t(toks)})
    assert set(met) == set(jmet)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in ("ce_loss", "moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(met["moe_drop_frac"]) == float(jmet["moe_drop_frac"])
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 32 - 1


def test_kernel_path_loss_matches_plain(pair):
    """With ``use_kernels`` the flash op runs once a layer (its plain
    version on the CPU) and gives the einsum path's loss."""
    cfg, _, tp = pair
    toks = _t(_tokens(cfg, (2, 33)))
    plain = build_model(get_smoke(cfg.name), device="cpu")
    kern = build_model(get_smoke(cfg.name).replace(use_kernels=True),
                       device="cpu")
    flash_ops.reset_launch_counts()
    lk = float(kern.train_loss(tp, {"tokens": toks})[0])
    assert flash_ops.launch_counts["flash_attention"] == cfg.n_layers
    np.testing.assert_allclose(lk, float(plain.train_loss(
        tp, {"tokens": toks})[0]), rtol=1e-5)


def test_prefill_and_eight_decode_steps_match_jax(pair):
    cfg, jp, tp = pair
    jm = jax_build(cfg)
    tm = build_model(get_smoke(cfg.name), device="cpu")
    toks = _tokens(cfg, (2, 12))
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :4])},
                              max_len=16)
    with torch.no_grad():
        tlog, tcache = tm.prefill(tp, {"tokens": _t(toks[:, :4])},
                                  max_len=16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    np.testing.assert_allclose(tcache.kv.k.numpy(), np.asarray(jcache.kv.k),
                               atol=1e-4)
    for i in range(4, 12):
        step = toks[:, i:i + 1]
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(step))
        with torch.no_grad():
            tlog, tcache = tm.decode_step(tp, tcache, _t(step))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    for got, want in ((tcache.kv.k, jcache.kv.k), (tcache.kv.v, jcache.kv.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tcache.kv.length.tolist() == [12, 12]


def test_init_gives_the_reference_shapes(pair):
    cfg, jp, _ = pair
    tm = build_model(get_smoke(cfg.name), device="cpu")
    p = tm.init(tm.generator(0))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == \
        jax.tree.map(lambda a: a.shape, jp)
    assert tm.param_count() == sum(a.size for a in jax.tree.leaves(jp))


def test_vlm_still_raises():
    """The VLM branch is ported (its specs add ``patch_proj``, its blocks
    are dense); a VLM batch without its patch embeddings still raises."""
    from repro_torch.models import transformer
    cfg = get_smoke("moonshot-v1-16b-a3b").replace(family="vlm")
    assert "mlp" in transformer.block_specs(cfg)
    assert transformer.lm_specs(cfg)["patch_proj"].shape == \
        (cfg.d_model, cfg.d_model)
    tm = build_model(cfg, device="cpu")
    with pytest.raises(KeyError, match="patches"):
        tm.train_loss(tm.init(tm.generator(0)),
                      {"tokens": torch.zeros((1, 9), dtype=torch.long)})

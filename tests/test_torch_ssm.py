"""The port's mamba2 and zamba2 models on the CPU against the JAX package.

``get_smoke("mamba2-130m")`` (pure SSM) and ``get_smoke("zamba2-2.7b")``
(Mamba2 layers + the shared attention block) with the JAX parameters
carried over by ``params_from_reference``: the Mamba2 block (train with
its states, and one decode step), ``train_loss`` with and without the
kernel path, ``prefill`` and eight ``decode_step`` s, each against the
JAX function on the same inputs; and the full configs' parameter counts.

Tolerances: 1e-5 relative for float32 losses (the same products summed
in another order by another BLAS; the inter-chunk scan is sequential
here, associative in the reference); 1e-4 absolute for logits, caches and
states (unit-scale values after 2-4 layers); 1e-5 for one block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_smoke
from repro.models import mamba2 as jmamba
from repro.models.api import build_model as jax_build
from repro_torch.configs import get, get_smoke
from repro_torch.convert import params_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import build_model, mamba2
from repro_torch.models.hybrid import n_attn_sites
from repro_torch.models.transformer import layer_params

ARCHS = ["mamba2-130m", "zamba2-2.7b"]
RNG_SEED = 5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, JAX bundle, JAX params, port bundle, port params), the same
    weights in both."""
    cfg = jax_smoke(request.param)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke(request.param), device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _tokens(cfg, shape, seed=RNG_SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_params_carry_over_unchanged(pair):
    """``params_from_reference`` is generic over nested dicts: the ssm and
    hybrid trees cross with every leaf's path, shape and values."""
    _, _, jp, tm, tp = pair
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (_, t), (_, j) in zip(tleaves, jleaves):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(),
                                                           np.asarray(j))
    init = tm.init(tm.generator(0))
    assert jax.tree.map(lambda t: tuple(t.shape), init) == \
        jax.tree.map(lambda t: tuple(t.shape), tp)
    assert tm.param_count() == sum(t.numel() for t in jax.tree.leaves(init))


@pytest.mark.parametrize("S", [24, 20])
def test_ssd_block_train_matches_jax(pair, S):
    """One Mamba2 block with its end states; S = 20 is ragged in chunks
    of 8."""
    cfg, _, jp, _, tp = pair
    x = np.random.default_rng(1).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])["ssd"]
    tl = layer_params(tp["layers"], 0)["ssd"]
    want, (jconv, jh) = jmamba.ssd_block_train(cfg, jl, jnp.asarray(x),
                                               return_state=True)
    got, (tconv, th) = mamba2.ssd_block_train(get_smoke(cfg.name), tl, _t(x),
                                              return_state=True)
    _close(got, want, 1e-5)
    _close(tconv, jconv, 1e-5)
    _close(th, jh, 1e-5)


def test_ssd_block_decode_matches_jax(pair):
    cfg, _, jp, _, tp = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.conv_width - 1, cfg.d_inner
                                + 2 * cfg.ssm_state)).astype(np.float32)
    h = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_state,
                             cfg.ssm_head_dim)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])["ssd"]
    tl = layer_params(tp["layers"], 0)["ssd"]
    want, (jconv, jh) = jmamba.ssd_block_decode(
        cfg, jl, jnp.asarray(x), (jnp.asarray(conv), jnp.asarray(h)))
    got, (tconv, th) = mamba2.ssd_block_decode(get_smoke(cfg.name), tl, _t(x),
                                               (_t(conv), _t(h)))
    _close(got, want, 1e-5)
    _close(tconv, jconv, 1e-5)
    _close(th, jh, 1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_loss_matches_jax(pair, use_kernels):
    cfg, jm, jp, _, tp = pair
    tm = build_model(get_smoke(cfg.name).replace(use_kernels=use_kernels),
                     device="cpu")
    toks = _tokens(cfg, (2, 37))                # 36 positions: ragged chunks
    toks[1, -1] = -1                            # a masked label
    want, jmet = jm.train_loss(jp, {"tokens": jnp.asarray(toks)})
    ssd_ops.reset_launch_counts()
    flash_ops.reset_launch_counts()
    got, met = tm.train_loss(tp, {"tokens": _t(toks)})
    sites = n_attn_sites(cfg) if cfg.family == "hybrid" else 0
    assert (ssd_ops.launch_counts["ssd_scan"],
            flash_ops.launch_counts["flash_attention"]) == \
        ((cfg.n_layers, sites) if use_kernels else (0, 0))
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 36 - 1
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_prefill_matches_jax(pair):
    cfg, jm, jp, tm, tp = pair
    toks = _tokens(cfg, (2, 12))
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=16)
    tlog, tcache = tm.prefill(tp, {"tokens": _t(toks)}, max_len=16)
    assert tlog.shape == (2, 1, cfg.vocab_size)
    _close(tlog, jlog, 1e-4)
    jleaves, tleaves = jax.tree.leaves(jcache), list(_leaves(tcache))
    assert len(tleaves) == len(jleaves)
    for got, want in zip(tleaves, jleaves):
        assert tuple(got.shape) == want.shape
        _close(got, want, 1e-4)


def test_eight_decode_steps_match_jax(pair):
    cfg, jm, jp, tm, tp = pair
    toks = _tokens(cfg, (2, 12))
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :4])},
                           max_len=16)
    _, tcache = tm.prefill(tp, {"tokens": _t(toks[:, :4])}, max_len=16)
    for i in range(4, 12):
        step = toks[:, i:i + 1]
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(step))
        tlog, tcache = tm.decode_step(tp, tcache, _t(step))
        _close(tlog, jlog, 1e-4)
    for got, want in zip(_leaves(tcache), jax.tree.leaves(jcache)):
        _close(got, want, 1e-4)
    assert tcache.length.tolist() == [12, 12]


def test_decode_from_empty_cache_matches_prefill(pair):
    """The port's own serving consistency (tests/test_models_smoke.py:63),
    through the kernel path's prefill."""
    cfg, _, _, _, tp = pair
    tm = build_model(get_smoke(cfg.name).replace(use_kernels=True),
                     device="cpu")
    toks = _t(_tokens(cfg, (2, 8)))
    plog, pcache = tm.prefill(tp, {"tokens": toks}, max_len=32)
    cache = tm.init_cache(2, 32)
    for i in range(8):
        dlog, cache = tm.decode_step(tp, cache, toks[:, i:i + 1])
    np.testing.assert_allclose(plog[:, -1].numpy(), dlog[:, -1].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(pcache.ssm.h.numpy(), cache.ssm.h.numpy(),
                               atol=1e-4)


def _leaves(cache):
    for v in cache:
        if isinstance(v, tuple):
            yield from v
        else:
            yield v


@pytest.mark.parametrize("arch,count", [("mamba2-130m", 128_983_488),
                                        ("zamba2-2.7b", 2_396_455_840)])
def test_full_config_matches_the_reference(arch, count):
    """The full configs: the reference's published numbers, and the spec
    count of the JAX package's ``build_model`` (``ArchConfig.param_count``
    differs for the hybrid: it counts an MLP in every layer)."""
    cfg = get(arch)
    jcfg = jax_get(arch)
    assert {k: v for k, v in vars(cfg).items()} == \
        {k: v for k, v in vars(jcfg).items()}
    assert build_model(cfg, device="cpu").param_count() == count
    assert jax_build(jcfg).param_count() == count
    assert cfg.param_count() == jcfg.param_count()

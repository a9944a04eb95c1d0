"""The port's tinyllama model on the CPU against the JAX package.

The layers on seeded numpy inputs, then ``get_smoke("tinyllama-1.1b")``
with the JAX parameters carried over by ``params_from_reference``:
``train_loss`` with and without the kernel path, ``prefill`` and eight
``decode_step`` s, each against the JAX function on the same inputs.

Tolerances: 1e-5 relative for float32 losses (the same products summed
in another order by another BLAS), 1e-4 absolute for logits and caches
(unit-scale values after 2 layers), 1e-5 for single layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_smoke as jax_smoke
from repro.models import layers as jl
from repro.models.api import build_model as jax_build
from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.convert import params_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model, layers as tl

ARCH = "tinyllama-1.1b"
RNG_SEED = 5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX bundle, JAX params, port bundle, port params), the same
    weights in both."""
    cfg = jax_smoke(ARCH)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke(ARCH), device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _tokens(cfg, shape, seed=RNG_SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# -- layers ---------------------------------------------------------------

def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(w), 1e-5).numpy(),
                               np.asarray(jl.rms_norm(x, w, 1e-5)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_rotary_matches(head_dim):
    rng = np.random.default_rng(1)
    pos = np.arange(40, dtype=np.int32)[None] + 3
    x = rng.standard_normal((1, 40, 3, head_dim)).astype(np.float32)
    jc, js = jl.rotary_embedding(jnp.asarray(pos), head_dim, 10000.0)
    tc, ts = tl.rotary_embedding(_t(pos), head_dim, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(tl.apply_rotary(_t(x), tc, ts).numpy(),
                               np.asarray(jl.apply_rotary(x, jc, js)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches(mlp):
    cfg = jax_smoke(ARCH).replace(mlp=mlp)
    rng = np.random.default_rng(2)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
         .astype(np.float32) for k, s in jl.mlp_specs(cfg).items()}
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    got = tl.mlp_apply(get_smoke(ARCH).replace(mlp=mlp),
                       {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.mlp_apply(cfg, p, x)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(48, 16), (50, 16), (10, 16)])
def test_chunked_cross_entropy_matches(S, chunk):
    """Whole chunks, whole chunks + a remainder, and one short chunk."""
    cfg = jax_smoke(ARCH)
    rng = np.random.default_rng(3)
    p = {"embedding": (0.02 * rng.standard_normal((cfg.vocab_size,
                                                     cfg.d_model))),
         "unembed": rng.standard_normal((cfg.d_model, cfg.vocab_size))
         / np.sqrt(cfg.d_model)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    h = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    y = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    m = (rng.random((2, S)) > 0.2).astype(np.float32)
    jl_, jc = jl.chunked_cross_entropy(p, h, y, m, chunk)
    tl_, tc = tl.chunked_cross_entropy({k: _t(v) for k, v in p.items()},
                                       _t(h), _t(y), _t(m), chunk)
    assert float(tc) == float(jc)
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_loss_matches_jax(pair, use_kernels):
    cfg, jm, jp, _, tp = pair
    tm = build_model(get_smoke(ARCH).replace(use_kernels=use_kernels),
                     device="cpu")
    toks = _tokens(cfg, (2, 33))
    toks[1, -1] = -1                            # a masked label
    want, jmet = jm.train_loss(jp, {"tokens": jnp.asarray(toks)})
    flash_ops.reset_launch_counts()
    got, met = tm.train_loss(tp, {"tokens": _t(toks)})
    assert flash_ops.launch_counts["flash_attention"] == \
        (cfg.n_layers if use_kernels else 0)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 32 - 1
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_prefill_matches_jax(pair):
    cfg, jm, jp, tm, tp = pair
    toks = _tokens(cfg, (2, 8))
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=16)
    tlog, tcache = tm.prefill(tp, {"tokens": _t(toks)}, max_len=16)
    assert tlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    for got, want in ((tcache.kv.k, jcache.kv.k), (tcache.kv.v, jcache.kv.v)):
        assert got.shape == want.shape == (cfg.n_layers, 2, 16,
                                           cfg.n_kv_heads, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tcache.kv.length.tolist() == np.asarray(jcache.kv.length).tolist()


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
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    np.testing.assert_allclose(tcache.kv.k.numpy(), np.asarray(jcache.kv.k),
                               atol=1e-4)
    assert tcache.kv.length.tolist() == [12, 12]


def test_decode_from_empty_cache_matches_prefill(pair):
    """The port's own serving consistency (tests/test_models_smoke.py:63)."""
    cfg, _, _, tm, tp = pair
    toks = _t(_tokens(cfg, (2, 8)))
    plog, _ = tm.prefill(tp, {"tokens": toks}, max_len=32)
    cache = tm.init_cache(2, 32)
    for i in range(8):
        dlog, cache = tm.decode_step(tp, cache, toks[:, i:i + 1])
    np.testing.assert_allclose(plog[:, -1].numpy(), dlog[:, -1].numpy(),
                               atol=1e-4)


def test_attention_decode_writes_the_cache_in_place(pair):
    """One row mid-cache, one full: the port writes the new K/V into the
    caller's buffers (the full row left as it is) and gives the caches
    and output of the JAX package's one-hot blend."""
    from repro.models.attention import attention_decode as jax_decode
    from repro_torch.models.attention import attention_decode
    from repro_torch.models.transformer import layer_params
    cfg, _, jp, _, tp = pair
    rng = np.random.default_rng(3)
    S_max, hd = 8, cfg.resolved_head_dim()
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, S_max, cfg.n_kv_heads, hd))
              .astype(np.float32) for _ in range(2))
    lengths = np.array([3, S_max], np.int32)
    jo, jk, jv = jax_decode(cfg, jax.tree.map(lambda a: a[0],
                                              jp["layers"]["attn"]),
                            x, kc, vc, lengths)
    tk, tv = _t(kc.copy()), _t(vc.copy())
    to, rk, rv = attention_decode(get_smoke(ARCH),
                                  layer_params(tp["layers"], 0)["attn"],
                                  _t(x), tk, tv, _t(lengths))
    assert rk is tk and rv is tv
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    for got, want, before in ((tk, jk, kc), (tv, jv, vc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), before[1])
        np.testing.assert_array_equal(np.delete(got[0].numpy(), 3, 0),
                                      np.delete(before[0], 3, 0))


def test_chunked_attention_path_matches_einsum(pair, monkeypatch):
    """Above the threshold the plain path loops over query chunks; it
    gives the einsum path's loss."""
    import repro_torch.models.attention as attn
    cfg, _, _, tm, tp = pair
    toks = _t(_tokens(cfg, (2, 65)))
    whole = float(tm.train_loss(tp, {"tokens": toks})[0])
    monkeypatch.setattr(attn, "CHUNKED_ATTN_THRESHOLD", 16)
    calls = []
    real = attn.chunked_gqa_attend
    monkeypatch.setattr(attn, "chunked_gqa_attend",       # 4 query chunks
                        lambda *a, **k: calls.append(1) or real(*a, **k,
                                                                q_chunk=16))
    chunked = float(tm.train_loss(tp, {"tokens": toks})[0])
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(chunked, whole, rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_gqa_attend_matches_jax(causal):
    from repro.models.attention import chunked_gqa_attend as jax_chunked
    from repro_torch.models.attention import chunked_gqa_attend
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 48, 4, 16), (2, 48, 2, 16), (2, 48, 2, 16)))
    want = jax_chunked(q, k, v, causal=causal, softmax_scale=0.25,
                       q_chunk=16)
    got = chunked_gqa_attend(_t(q), _t(k), _t(v), causal=causal,
                             softmax_scale=0.25, q_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_gives_the_reference_shapes_and_distributions():
    cfg = get_smoke(ARCH)
    tm = build_model(cfg, device="cpu")
    p = tm.init(tm.generator(0))
    jshapes = jax.tree.map(lambda s: s.shape,
                           jax_build(jax_smoke(ARCH)).abstract_params())
    tshapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert tshapes == jshapes
    assert tm.param_count() == sum(t.numel() for t in jax.tree.leaves(p))
    assert float(p["layers"]["attn_norm"].abs().max()) == 0.0
    assert abs(float(p["embed"]["embedding"].std()) - 0.02) < 0.002
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    again = tm.init(tm.generator(0))
    assert torch.equal(again["layers"]["mlp"]["w_up"],
                       p["layers"]["mlp"]["w_up"])


def test_full_config_is_tinyllama():
    cfg = get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size) == \
        (22, 2048, 32, 4, 64, 5632, 32000)
    assert cfg.pdtype() == cfg.cdtype() == torch.float32
    assert ARCHS == JAX_ARCHS            # all ten, in the reference's order
    with pytest.raises(KeyError, match="unknown architecture"):
        get("llama-3-8b")


@pytest.mark.parametrize("family", ["retnet", "rwkv"])
def test_build_model_refuses_families_not_ported(family):
    """Every family of the JAX package builds; any other is refused."""
    with pytest.raises(ValueError, match="unknown family"):
        build_model(get_smoke(ARCH).replace(family=family), device="cpu")

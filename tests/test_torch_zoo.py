"""The rest of the model zoo on the CPU against the JAX package.

nemotron-4-15b, yi-6b and gemma-7b (dense: squared ReLU, SwiGLU, GeGLU
with tied embeddings and ``head_dim`` 32 != d_model / n_heads),
seamless-m4t-medium (the encoder-decoder) and internvl2-2b (the VLM),
each at its smoke config with the JAX parameters carried over by
``params_from_reference`` and the same seeded numpy tokens, frames and
patches: ``train_loss`` (and, for seamless and internvl2, every gradient
leaf and one train step), ``prefill``, eight ``decode_step`` s, and the
kernel path (the plain flash version on the CPU) against the JAX
package's Pallas kernel in interpret mode.

Tolerances: 1e-5 relative for float32 losses and step metrics (the same
products summed in another order by another BLAS); 1e-4 absolute for
logits and caches (unit-scale values after 2 layers); each gradient leaf
1e-5 relative and 1e-4 of that leaf's largest magnitude, as in
tests/test_torch_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models.api import build_model as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.training.trainer import TrainState as JaxTrainState
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get, get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_reference
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, warmup_cosine
from repro_torch.optim.tree import leaves, unflatten_like
from repro_torch.training import TrainState, make_train_step

ZOO = ["nemotron-4-15b", "yi-6b", "gemma-7b", "seamless-m4t-medium",
       "internvl2-2b"]
FRONTEND = ["seamless-m4t-medium", "internvl2-2b"]
FRONTEND_KEY = {"encdec": "frames", "vlm": "patches"}


def _pair(arch, **changes):
    """(JAX cfg, JAX bundle, JAX params, port bundle, port params) of the
    smoke config with ``changes``, the same weights in both."""
    cfg = jax_smoke(arch).replace(**changes)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke(arch).replace(**changes), device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module", params=ZOO)
def pair(request):
    return _pair(request.param)


def _batch(cfg, B, S, seed=5):
    """Seeded numpy tokens (B, S) and, for encdec / vlm, the frontend's
    (B, frontend_len, d_model) embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family in FRONTEND_KEY:
        out[FRONTEND_KEY[cfg.family]] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _caches(cache, family):
    """The cache's tensors, by name, in either package."""
    if family == "encdec":
        return {"k": cache.self_kv.k, "v": cache.self_kv.v,
                "cross_k": cache.cross_k, "cross_v": cache.cross_v,
                "length": cache.self_kv.length}
    return {"k": cache.kv.k, "v": cache.kv.v, "length": cache.kv.length}


def test_configs_are_the_references(pair):
    """The port's smoke and published configs field for field."""
    cfg = pair[0]
    assert dataclasses.asdict(get_smoke(cfg.name)) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(get(cfg.name)) == \
        dataclasses.asdict(jax_get(cfg.name))


def test_train_loss_matches_jax(pair):
    cfg, jm, jp, tm, tp = pair
    batch = _batch(cfg, 2, 33)
    batch["tokens"][1, -1] = -1                 # a masked label
    want, jmet = jm.train_loss(jp, _jax(batch))
    flash_ops.reset_launch_counts()
    got, met = tm.train_loss(tp, _torch(batch))
    assert flash_ops.launch_counts["flash_attention"] == 0
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 32 - 1
    assert set(met) == set(jmet)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", FRONTEND)
def test_loss_and_grads_match(arch):
    cfg, jm, jp, tm, tp = _pair(arch)
    batch = _batch(cfg, 4, 33, seed=7)
    jloss, jg = jax.value_and_grad(
        lambda p: jm.train_loss(p, _jax(batch))[0])(jp)
    flat = [p.detach().requires_grad_(True) for p in leaves(tp)]
    loss, _ = tm.train_loss(unflatten_like(tp, flat), _torch(batch))
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-4 * float(np.max(np.abs(w))))


@pytest.mark.parametrize("run", ["plain", "microbatch2"])
@pytest.mark.parametrize("arch", FRONTEND)
def test_train_step_metrics_match(arch, run):
    """One ``make_train_step`` step: the frontend's embeddings split into
    microbatches with the tokens."""
    cfg, jm, jp, tm, tp = _pair(arch)
    kw = {"microbatch": 2} if run == "microbatch2" else {}
    batch = _batch(cfg, 4, 33, seed=7)
    jstate = JaxTrainState(params=jp, opt=jax_adamw_init(jp), residual=None,
                           step=jnp.asarray(3, jnp.int32))
    tstate = TrainState(params=tp, opt=adamw_init(tp), residual=None,
                        step=torch.tensor(3, dtype=torch.int32))
    jstep = jax.jit(jax_make_train_step(jm, JaxRunConfig(**kw),
                                        jax_warmup_cosine(1e-3, 10, 100)))
    tstep = make_train_step(tm, RunConfig(**kw), warmup_cosine(1e-3, 10, 100))
    jnew, jmet = jstep(jstate, _jax(batch))
    tnew, tmet = tstep(tstate, _torch(batch))
    assert set(tmet) == set(jmet)
    for k in ("loss", "grad_norm", "param_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(tnew.step) == int(jnew.step) == 4


def test_prefill_matches_jax(pair):
    cfg, jm, jp, tm, tp = pair
    batch = _batch(cfg, 2, 8)
    jlog, jcache = jm.prefill(jp, _jax(batch), max_len=32)
    tlog, tcache = tm.prefill(tp, _torch(batch), max_len=32)
    assert tlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    got, want = _caches(tcache, cfg.family), _caches(jcache, cfg.family)
    assert set(got) == set(want)
    for name in got:
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, err_msg=name)
    prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    assert got["length"].tolist() == [8 + prefix] * 2


def test_eight_decode_steps_match_jax(pair):
    cfg, jm, jp, tm, tp = pair
    batch = _batch(cfg, 2, 12)
    first = {k: v[:, :4] if k == "tokens" else v for k, v in batch.items()}
    _, jcache = jm.prefill(jp, _jax(first), max_len=32)
    _, tcache = tm.prefill(tp, _torch(first), max_len=32)
    for i in range(4, 12):
        step = batch["tokens"][:, i:i + 1]
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(step))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step).long())
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    got, want = _caches(tcache, cfg.family), _caches(jcache, cfg.family)
    np.testing.assert_allclose(got["k"].numpy(), np.asarray(want["k"]),
                               atol=1e-4)
    prefix = cfg.frontend_len if cfg.family == "vlm" else 0
    assert got["length"].tolist() == [12 + prefix] * 2


@pytest.mark.parametrize("arch", FRONTEND)
def test_prefill_then_decode_equals_longer_prefill(arch):
    """prefill(S - 1) + one decode step = prefill(S): the frontend's
    context exists only through prefill (tests/test_models_smoke.py:52),
    and both packages agree on it."""
    cfg, jm, jp, tm, tp = _pair(arch)
    batch = _torch(_batch(cfg, 2, 8, seed=9))
    whole, _ = tm.prefill(tp, batch, max_len=32)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = tm.prefill(tp, short, max_len=32)
    step, _ = tm.decode_step(tp, cache, batch["tokens"][:, -1:])
    np.testing.assert_allclose(step[:, -1].numpy(), whole[:, -1].numpy(),
                               atol=1e-4)
    want, _ = jm.prefill(jp, {k: jnp.asarray(v.numpy())
                              for k, v in batch.items()}, max_len=32)
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("arch", ["gemma-7b", "seamless-m4t-medium"])
def test_kernel_path_matches_pallas_interpret(arch):
    """``use_kernels=True``: the port's plain flash version on the CPU
    against the JAX package's Pallas kernel in interpret mode; gemma at
    its smoke head dim 32, seamless through the non-causal encoder and the
    causal decoder.  One flash call per self-attention layer."""
    cfg, jm, jp, tm, tp = _pair(arch, use_kernels=True)
    batch = _batch(cfg, 2, 33)
    want, _ = jm.train_loss(jp, _jax(batch))
    flash_ops.reset_launch_counts()
    got, _ = tm.train_loss(tp, _torch(batch))
    per_loss = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec"
                               else 0)
    assert flash_ops.launch_counts["flash_attention"] == per_loss
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_init_gives_the_reference_shapes(pair):
    cfg, jm, _, tm, _ = pair
    p = tm.init(tm.generator(0))
    jshapes = jax.tree.map(lambda s: s.shape, jm.abstract_params())
    assert jax.tree.map(lambda t: tuple(t.shape), p) == jshapes
    assert tm.param_count() == sum(t.numel() for t in jax.tree.leaves(p))
    if cfg.family == "vlm":
        assert p["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    if cfg.family == "encdec":
        assert p["encoder"]["attn"]["wq"].shape[0] == cfg.enc_layers

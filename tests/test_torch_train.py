"""The port's train step on the CPU against the JAX package's.

Smoke-size tinyllama, mamba2, zamba2 and moonshot (MoE) with the JAX
package's weights carried over by ``params_from_reference`` and the same
seeded tokens: the loss and every gradient leaf, then one whole
``make_train_step`` step's metrics (plain, with two microbatches, and
with int8 error-feedback compression).  Gradients and the optimizer are compared
apart (the optimizer in ``tests/test_torch_optim.py``): AdamW's first
step moves a parameter by ±lr whatever the size of its gradient, so a
gradient near zero whose sign differs between the packages would move
it by 2·lr.  In the port, ``remat`` on and off give the same loss and
gradients.

Tolerances: the loss and the step's metrics 1e-5 relative (float32 sums
in another order by another BLAS); each gradient leaf 1e-5 relative and
1e-4 of that leaf's largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models.api import build_model as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.compress import init_residual as jax_init_residual
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.training.trainer import TrainState as JaxTrainState
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, warmup_cosine
from repro_torch.optim.compress import init_residual
from repro_torch.optim.tree import leaves, unflatten_like
from repro_torch.training import TrainState, make_train_step

ARCHS = ["tinyllama-1.1b", "mamba2-130m", "zamba2-2.7b", "moonshot-v1-16b-a3b"]
SHAPE = (4, 33)
RUNS = {"plain": {}, "microbatch2": {"microbatch": 2},
        "compress": {"grad_compress": True}}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX cfg, JAX bundle, JAX params, port bundle, port params, tokens),
    the same weights in both."""
    arch = request.param
    cfg = jax_smoke(arch)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke(arch), device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, SHAPE).astype(np.int32)
    return cfg, jm, jp, tm, tp, toks


def _grads(model, params, tokens):
    """The loss and its gradients, in ``jax.tree.leaves`` order."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = model.train_loss(unflatten_like(params, flat),
                               {"tokens": tokens})
    return loss, torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
def test_loss_and_grads_match(pair, remat):
    cfg, jm, jp, tm, tp, toks = pair
    jloss, jg = jax.value_and_grad(
        lambda p: jm.train_loss(p, {"tokens": jnp.asarray(toks)})[0])(jp)
    model = build_model(get_smoke(cfg.name).replace(remat=remat),
                        device="cpu")
    loss, grads = _grads(model, tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-4 * float(np.max(np.abs(w))))


def test_remat_on_and_off_agree(pair):
    cfg, _, _, _, tp, toks = pair
    outs = []
    for remat in (True, False):
        model = build_model(get_smoke(cfg.name).replace(remat=remat),
                            device="cpu")
        outs.append(_grads(model, tp, torch.from_numpy(toks).long()))
    (l1, g1), (l2, g2) = outs
    np.testing.assert_allclose(float(l1.detach()), float(l2.detach()),
                               rtol=1e-6)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7 * float(b.abs().max()))


@pytest.mark.parametrize("run", list(RUNS))
def test_train_step_metrics_match(pair, run):
    cfg, jm, jp, tm, tp, toks = pair
    kw = RUNS[run]
    jrun, trun = JaxRunConfig(**kw), RunConfig(**kw)
    jstate = JaxTrainState(
        params=jp, opt=jax_adamw_init(jp),
        residual=jax_init_residual(jp) if jrun.grad_compress else None,
        step=jnp.asarray(3, jnp.int32))
    tstate = TrainState(
        params=tp, opt=adamw_init(tp),
        residual=init_residual(tp) if trun.grad_compress else None,
        step=torch.tensor(3, dtype=torch.int32))
    jstep = jax.jit(jax_make_train_step(jm, jrun,
                                        jax_warmup_cosine(1e-3, 10, 100)))
    tstep = make_train_step(tm, trun, warmup_cosine(1e-3, 10, 100))
    jnew, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
    before = [p.clone() for p in leaves(tp)]
    tnew, tmet = tstep(tstate, {"tokens": torch.from_numpy(toks).long()})
    assert set(tmet) == set(jmet)
    for k in ("loss", "grad_norm", "param_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(tnew.step) == int(jnew.step) == 4
    assert int(tnew.opt.step) == int(jnew.opt.step) == 1
    assert (tnew.residual is None) == (jnew.residual is None)
    # the step is a function: the state it was given is unchanged
    assert all(torch.equal(a, b) for a, b in zip(leaves(tp), before))
    assert not any(m.any() for m in leaves(tstate.opt.mu))


def test_microbatches_must_divide_the_batch(pair):
    _, _, _, tm, tp, toks = pair
    step = make_train_step(tm, RunConfig(microbatch=3),
                           warmup_cosine(1e-3, 10, 100))
    state = TrainState(tp, adamw_init(tp), None, torch.tensor(0))
    with pytest.raises(ValueError, match="microbatches"):
        step(state, {"tokens": torch.from_numpy(toks).long()})


def test_train_state_is_a_dataclass_twin():
    assert [f.name for f in dataclasses.fields(TrainState)] == \
        [f.name for f in dataclasses.fields(JaxTrainState)]

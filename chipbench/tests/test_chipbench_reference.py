"""The frozen reference against the port at smoke size on the CPU (a
test may import both; the reference imports nothing of the port): the
loss and every leaf's gradient of the port's ``train_loss``, and two
steps of its train step with AdamW and the warmup-cosine rate."""
import dataclasses

import pytest
import torch

from chipbench.harness import registry, weights
from chipbench.reference import train as ref_train


def _cfg(config, **over):
    from repro_torch.configs import get_smoke
    arch = get_smoke(config).replace(**over)
    cfg = dict(registry.config(registry.benchmark(), config),
               arch=dataclasses.asdict(arch))
    return arch, cfg


@pytest.mark.parametrize("config", ["mamba2-130m", "zamba2-2.7b"])
@pytest.mark.parametrize("seq", [40, 64])
def test_loss_and_gradients_equal_the_port(config, seq):
    from repro_torch.models.api import build_model
    arch, cfg = _cfg(config)
    model = build_model(arch, device="cpu")
    tokens = torch.randint(0, arch.vocab_size, (2, seq + 1),
                           generator=torch.Generator().manual_seed(3))
    params = weights.make(model.specs, 7, "cpu")
    leaves = [p.requires_grad_(True) for _, p in ref_train.flatten(params)]
    loss, _ = model.train_loss(params, {"tokens": tokens})
    g_port = torch.autograd.grad(loss, leaves)
    ref = ref_train.family(cfg).loss(params, tokens, ref_train.arch_of(cfg))
    g_ref = torch.autograd.grad(ref, leaves)
    assert float(ref) == pytest.approx(float(loss), rel=1e-6)
    for (name, _), a, b in zip(ref_train.flatten(params), g_port, g_ref):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("config", ["mamba2-130m", "zamba2-2.7b"])
def test_steps_equal_the_ports_train_step(config):
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init, warmup_cosine
    from repro_torch.training.trainer import TrainState, make_train_step
    traffic = registry.traffic(next(
        w["traffic"] for w in registry.benchmark()["workloads"]
        if w["config"] == config))
    opt = traffic["optimizer"]
    arch, cfg = _cfg(config)
    model = build_model(arch, device="cpu")
    run = RunConfig(learning_rate=opt["learning_rate"],
                    weight_decay=opt["weight_decay"])
    step = make_train_step(model, run, warmup_cosine(
        opt["learning_rate"], opt["warmup_steps"], opt["total_steps"]))
    batches = [torch.randint(0, arch.vocab_size, (2, 33),
                             generator=torch.Generator().manual_seed(i))
               for i in range(3)]
    w0 = weights.make(model.specs, 9, "cpu")
    state = TrainState(params=w0, opt=adamw_init(w0), residual=None,
                       step=torch.zeros((), dtype=torch.int32))
    losses = []
    for b in batches:
        state, metrics = step(state, {"tokens": b})
        losses.append(float(metrics["loss"]))
    ref = ref_train.follow(lambda: weights.make(model.specs, 9, "cpu"),
                           batches, cfg, opt)
    assert ref["losses"] == pytest.approx(losses, rel=1e-6)
    start = dict(ref_train.flatten(weights.make(model.specs, 9, "cpu")))
    for name, p in ref_train.flatten(state.params):
        got = float(torch.linalg.vector_norm(p - start[name]))
        assert got == pytest.approx(ref["change_norms"][name], rel=1e-3,
                                    abs=1e-9), name

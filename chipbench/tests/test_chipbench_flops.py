"""The frozen FLOP count against ``FlopCounterMode`` over the plain
reference at smoke size, remat off: the whole products of the forward,
and three times them with the backward."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from chipbench.flops.count import forward_products, train_step_flops
from chipbench.harness import registry, weights
from chipbench.reference import train as ref_train


def _setup(config, batch, seq):
    from repro_torch.configs import get_smoke
    from repro_torch.models.api import build_model
    cfg = registry.config(registry.benchmark(), config)
    cfg = dict(cfg, arch=dataclasses.asdict(get_smoke(config)))
    specs = build_model(get_smoke(config), device="cpu").specs
    params = weights.make(specs, 5, "cpu")
    tokens = torch.randint(0, cfg["arch"]["vocab_size"], (batch, seq + 1),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, tokens


@pytest.mark.parametrize("config", ["mamba2-130m", "zamba2-2.7b"])
@pytest.mark.parametrize("batch,seq", [(2, 32), (1, 29)])
def test_count_equals_flop_counter(config, batch, seq):
    cfg, params, tokens = _setup(config, batch, seq)
    arch, fam = ref_train.arch_of(cfg), ref_train.family(cfg)
    leaves = [p.requires_grad_(True) for _, p in ref_train.flatten(params)]
    with FlopCounterMode(display=False) as fwd:
        loss = fam.loss(params, tokens, arch, remat=False)
    dense = sum(f for _, f in forward_products(cfg["arch"], batch, seq,
                                               needed=False))
    assert fwd.get_total_flops() == dense
    with FlopCounterMode(display=False) as both:
        loss = fam.loss(params, tokens, arch, remat=False)
        torch.autograd.grad(loss, leaves)
    assert both.get_total_flops() == 3 * dense
    assert train_step_flops(cfg["arch"], batch, seq, needed=False) == 3 * dense


def test_needed_count_halves_the_causal_products():
    arch = registry.config(registry.benchmark(), "zamba2-2.7b")["arch"]
    whole = dict(forward_products(arch, 1, 4096, needed=False))
    need = dict(forward_products(arch, 1, 4096))
    assert need["attn.scores"] / whole["attn.scores"] == pytest.approx(
        4097 / 8192)
    assert need["ssd.chunk_y"] / whole["ssd.chunk_y"] == pytest.approx(
        65 / 128)
    assert need["mlp"] == whole["mlp"]


def test_full_size_counts():
    """At the configurations' sizes a token costs about 6 FLOPs a weight
    it meets: zamba2-2.7b's Mamba2 layers of ~39.8M, its shared block of
    ~78.6M at each site (one every 6 layers) and its 82M-wide head (the
    embedding is a lookup), plus the SSD's and attention's products on
    activations."""
    bench = registry.benchmark()
    z = registry.config(bench, "zamba2-2.7b")["arch"]
    m = registry.config(bench, "mamba2-130m")["arch"]
    zf = train_step_flops(z, 1, 4096) / 4096
    mf = train_step_flops(m, 8, 4096) / (8 * 4096)
    sites = -(-z["n_layers"] // 6)
    z_weights = z["n_layers"] * 39.8e6 + sites * 78.6e6 + 2560 * 32000
    assert 6 * z_weights < zf < 6 * z_weights * 1.06
    m_weights = 24 * 3.75e6 + 768 * 50280     # d 768, tied 50280 head
    assert 6 * m_weights < mf < 6 * m_weights * 1.4

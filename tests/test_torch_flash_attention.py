"""The port's flash attention on the CPU: the plain version against the
JAX package's Pallas kernel in interpret mode, and the public op's layout,
block contract and forward-only gradient.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances are the reference's own (tests/test_kernels.py): 2e-5 in
float32, 2e-2 in bfloat16 (one rounding of the output to 8 bits of
mantissa, and bf16 inputs rounded by each framework).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, nq, nkv, Sq, Sk, h, causal, bq, bk, dtype): the reference's SWEEP
# (tests/test_kernels.py:21-29) plus a GQA case with group 4, an MQA
# case with a short, full key axis and the h = 256 instance
CASES = [
    (1, 2, 2, 64, 64, 32, True, 32, 32, "float32"),
    (2, 4, 2, 128, 128, 64, True, 64, 64, "float32"),
    (1, 8, 1, 128, 128, 64, True, 128, 64, "float32"),     # MQA
    (2, 4, 4, 64, 128, 32, False, 64, 64, "float32"),      # cross-ish
    (1, 2, 2, 128, 128, 128, True, 64, 64, "float32"),     # big head
    (1, 4, 2, 64, 64, 64, True, 64, 64, "bfloat16"),
    (2, 8, 2, 64, 64, 32, True, 32, 32, "float32"),        # GQA, group 4
    (1, 4, 1, 32, 64, 64, False, 32, 32, "float32"),       # MQA, full
    # head dim 256 (gemma-7b), causal and full, float32 and bfloat16
    (1, 2, 2, 128, 128, 256, True, 64, 64, "float32"),
    (2, 2, 1, 64, 128, 256, False, 64, 64, "float32"),
    (1, 2, 2, 128, 128, 256, True, 64, 64, "bfloat16"),
    (1, 2, 2, 64, 128, 256, False, 64, 64, "bfloat16"),
]


def _inputs(case, seed):
    B, nq, nkv, Sq, Sk, h = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, nq, Sq, h), (B, nkv, Sk, h), (B, nkv, Sk, h))]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_interpret(case):
    B, nq, nkv, Sq, Sk, h, causal, bq, bk, dt = case
    arrays = _inputs(case, seed=CASES.index(case))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dt)) for a in arrays)
    want = flash_attention_kernel(jq, jk, jv, causal=causal, block_q=bq,
                                  block_k=bk, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dt)) for a in arrays)
    got = ref.attention(tq, tk, tv, causal=causal, softmax_scale=h ** -0.5)
    assert got.dtype == getattr(torch, dt) and got.shape == (B, nq, Sq, h)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dt], atol=TOL[dt])


def test_op_takes_the_models_layout():
    """ops.flash_attention: (B, S, heads, h) in and out, equal to the JAX
    kernel on the transposed inputs."""
    rng = np.random.default_rng(1)
    B, S, nq, nkv, h = 2, 64, 4, 2, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, nq, h), (B, S, nkv, h), (B, S, nkv, h)))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    want = flash_attention_kernel(*(jnp.swapaxes(jnp.asarray(a), 1, 2)
                                    for a in (q, k, v)),
                                  causal=True, interpret=True)
    np.testing.assert_allclose(got.numpy(),
                               np.swapaxes(np.asarray(want), 1, 2),
                               rtol=2e-5, atol=2e-5)


def test_op_counts_each_call():
    ops.reset_launch_counts()
    seen = []
    ops.on_launch = seen.append
    try:
        x = torch.zeros(1, 32, 2, 32)
        ops.flash_attention(x, x, x)
        ops.flash_attention(x, x[:, :, :1], x[:, :, :1])
    finally:
        ops.on_launch = None
    assert ops.launch_counts == {"flash_attention": 2}
    assert seen == ["flash_attention"] * 2


@pytest.mark.parametrize("shapes,msg", [
    (((1, 96, 2, 32), (1, 96, 2, 32)), "Sq=96"),      # 96 % 64 with bq=64
    (((1, 64, 2, 32), (1, 96, 2, 32)), "Sk=96"),
    (((1, 64, 3, 32), (1, 64, 2, 32)), "nq=3"),
])
def test_op_refuses_shapes_off_the_block_contract(shapes, msg):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=msg):
        ops.flash_attention(q, k, k, block_q=64, block_k=64)


def test_op_has_no_backward():
    q = torch.randn(1, 32, 2, 32, requires_grad=True)
    out = ops.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="forward only"):
        out.sum().backward()


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention import kernel
    x = torch.zeros(1, 2, 32, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(x, x, x, causal=True, softmax_scale=1.0)

"""The flash kernel's precision scheme, emulated on the CPU.

The CUDA kernel (``flash_attention/csrc/flash_attention.cu``) computes
float32 attention on the tensor cores in 3xTF32: each operand is split
into a big and a small TF32 part (round to nearest, ties away, 10-bit
mantissa), each product is a_small b_big + a_big b_small + a_big b_big
accumulated in float32, and the softmax runs online over tiles of keys
(64, or 32 at h = 128) in float32.  This file repeats that arithmetic in
plain torch and shows that it lands within the reference's float32
tolerance (2e-5,
tests/test_kernels.py) of the plain version on the reference's sweep and
on zamba2-2.7b's attention layer (h = 80) at B = 1 and 4 heads, while a
single TF32 product does not: the test guards the choice of 3xTF32.

Products of two TF32 values are exact in float32, so a float32 matrix
product of the split parts differs from the tensor cores' only in the
order of its sums.  Nothing on the port's path imports this emulation.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.kernel import tf32_tile

TOL = 2e-5                      # FLASH_TOL["float32"], tests/test_kernels.py
NEG_INF = -1e30


# (B, nq, nkv, Sq, Sk, h, causal): the float32 cases of the reference's
# sweep (tests/test_kernels.py:21-29), then zamba2-2.7b's layer (S = 2048,
# h = 80) at B = 1 and 4 heads
CASES = [
    (1, 2, 2, 64, 64, 32, True),
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 1, 128, 128, 64, True),
    (2, 4, 4, 64, 128, 32, False),
    (1, 2, 2, 128, 128, 128, True),
    (1, 4, 4, 2048, 2048, 80, True),
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10-bit mantissa), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does; the result is a float32."""
    b = x.contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((b & -(2 ** 31)) | mag).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """a @ b with TF32 operands: "3x" splits each into big + small parts
    and sums three products, "1x" rounds each once."""
    if scheme == "1x":
        return tf32(a) @ tf32(b)
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulate(q, k, v, *, causal: bool, scale: float, scheme: str):
    """The kernel's arithmetic: tiles of keys, S = Q K^T and O += P V
    in ``scheme``, scores scaled then masked (NEG_INF above the diagonal,
    -inf past Sk), online softmax in float32, O / l with l == 0 as 1."""
    B, nq, Sq, h = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, nkv, nq // nkv, Sq, h)
    rows = torch.arange(Sq)[:, None]
    bk = tf32_tile(h)
    m = torch.full((B, nkv, nq // nkv, Sq), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for k0 in range(0, Sk, bk):
        kt = k[:, :, None, k0:k0 + bk]
        vt = v[:, :, None, k0:k0 + bk]
        s = product(qg, kt.transpose(-1, -2), scheme) * scale
        cols = k0 + torch.arange(kt.shape[-2])[None, :]
        if causal:
            s = s.masked_fill(cols > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + product(p, vt, scheme)
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.reshape(B, nq, Sq, h)


def _inputs(case, seed):
    B, nq, nkv, Sq, Sk, h, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, nq, Sq, h), (B, nkv, Sk, h), (B, nkv, Sk, h))]


def _within(got, want):
    return bool(((got - want).abs() <= TOL + TOL * want.abs()).all())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                    # TF32's spacing in [1, 2)
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0 ** -23,
                      -(one + ulp / 2), one + 1.5 * ulp, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 3.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    # big + small holds x to 21 bits at least
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    big = tf32(y)
    rel = ((big + tf32(y - big)) - y).abs() / y.abs()
    assert float(rel.max()) <= 2.0 ** -21


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_within_the_reference_tolerance_and_1xtf32_not(case):
    q, k, v = _inputs(case, seed=CASES.index(case))
    causal, h = case[6], case[5]
    kw = dict(causal=causal, scale=h ** -0.5)
    want = ref.attention(q, k, v, causal=causal, softmax_scale=h ** -0.5)
    three = emulate(q, k, v, scheme="3x", **kw)
    one = emulate(q, k, v, scheme="1x", **kw)
    assert _within(three, want), float((three - want).abs().max())
    assert not _within(one, want), float((one - want).abs().max())

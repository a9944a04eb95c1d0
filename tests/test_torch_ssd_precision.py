"""The SSD kernel's arithmetic, emulated on the CPU.

The CUDA kernel (``ssd_scan/csrc/ssd_scan.cu``) computes the chunked SSD
scan chunk-parallel: a cluster of 1 to 8 blocks splits each (head,
batch row)'s chunks into contiguous ranges; every block but the last
folds its range's chunk states from zero (pass 1), block k folds the
states of blocks 0..k-1 in order into its starting state, and each block
then walks its range again from that state (pass 2).  Every product
(C B^T, M x, C h_prev, B^T (w x)) runs on the tensor cores in 3xTF32:
each operand is cut into a big and a small TF32 part (10-bit mantissa,
by truncation) and a b = a_s b_b + a_b b_s + a_b b_b is accumulated in
float32.

This file repeats that arithmetic in plain torch (:func:`emulate`) and
shows that it lands within the reference's sweep tolerance (2e-4,
tests/test_kernels.py) of the plain version for clusters of 1, 2 and 8
(a chunk count that is not a multiple of the cluster among them), and
within 2e-5 of max |y| and max |h| (chip_smoke.py's ``SSD_FULL_TOL``) at
one full-width mamba2-130m head (P = 64, N = 128, chunk 64) at batch 1
over 4096 steps (9.9e-7 of max |y| and 4.0e-7 of max |h| there).
Splitting by rounding to nearest, as the flash kernel does, halves that
(5.0e-7 and 1.8e-7) for five operations an element instead of the
truncation's three; both are far inside the limit.  A single TF32
product does not: 1xTF32, even rounded to nearest, misses
that limit at the same head by far (8.0e-4 of max |y|, forty times the
limit), so the test guards the choice of 3xTF32.

Products of two TF32 values are exact in float32, so a float32 matrix
product of the split parts differs from the tensor cores' only in the
order of its sums.  Nothing on the port's path imports this emulation.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ref

SSD_TOL = 2e-4                  # tests/test_kernels.py:117-120
FULL_TOL = 2e-5                 # chip_smoke.py SSD_FULL_TOL

# (B, S, H, P, N, chunk): tests/test_kernels.py's SSD_SWEEP with S < chunk
# (Q = 37) and ragged S = 100 among them, then ten chunks (8 blocks take
# one or two each)
CASES = [
    (1, 64, 2, 32, 16, 32),
    (2, 128, 4, 64, 32, 64),
    (1, 96, 2, 32, 16, 32),
    (2, 100, 3, 16, 8, 64),
    (1, 256, 1, 64, 64, 64),
    (1, 37, 2, 16, 16, 64),
    (1, 640, 2, 64, 32, 64),
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10-bit mantissa), to nearest with ties away
    from zero, as the flash kernel's ``tf32`` does; the result is a
    float32.  (A copy of tests/test_torch_flash_precision.py's.)"""
    b = x.contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((b & -(2 ** 31)) | mag).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """Cut float32 to TF32 by truncation, as the SSD kernel's ``split``
    does (its mask 0xffffe000)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """a @ b with TF32 operands: "3x" splits each into big + small parts
    by truncation and sums three products, as the kernel does; "3x-rn"
    splits by rounding to nearest, as the flash kernel does; "1x" rounds
    each once to nearest (the better of the single products)."""
    if scheme == "1x":
        return tf32(a) @ tf32(b)
    cut = tf32 if scheme == "3x-rn" else tf32_cut
    a_big, b_big = cut(a), cut(b)
    a_small, b_small = cut(a - a_big), cut(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulate(x, dt, A, Bm, Cm, chunk: int, cluster: int, scheme: str = "3x"):
    """The kernel's scan: y (B,S,H,P) and the final state (B,H,N,P)."""
    Bsz, S0, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S0)
    pad = (-S0) % Q                 # the op pads with dt = 0 steps
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // Q
    cluster = min(cluster, nc)
    xc = x.reshape(Bsz, nc, Q, H, P).permute(0, 1, 3, 2, 4)   # b c h q p
    Bc = Bm.reshape(Bsz, nc, 1, Q, N)
    Cc = Cm.reshape(Bsz, nc, 1, Q, N)
    s = torch.cumsum(dt.reshape(Bsz, nc, Q, H) * A, 2).permute(0, 1, 3, 2)
    dtc = dt.reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2)       # b c h q
    sq = s[..., -1:]
    # the chunk-parallel part: M, M x, the chunk states
    G = product(Cc, Bc.transpose(-1, -2), scheme)             # b c 1 q q
    low = torch.ones(Q, Q, dtype=torch.bool).tril()
    diff = torch.where(low, s[..., :, None] - s[..., None, :], 0.0)
    M = torch.where(low, G * diff.exp() * dtc[..., None, :], 0.0)
    w = torch.exp(sq - s) * dtc                                # b c h q
    st = product((Bc * w[..., None]).transpose(-1, -2), xc, scheme)
    decay = sq.exp()[..., None]                                # b c h 1 1
    # pass 1: each range's own state from zero, and its decay D
    bounds = [k * nc // cluster for k in range(cluster + 1)]
    hloc, D = [], []
    for k in range(cluster - 1):
        h = torch.zeros(Bsz, H, N, P)
        for c in range(bounds[k], bounds[k + 1]):
            h = decay[:, c] * h + st[:, c]
        hloc.append(h)
        D.append(sq[:, bounds[k]:bounds[k + 1], :, 0].sum(1))  # b h
    # pass 2: from the earlier ranges' states folded in order
    y = torch.empty(Bsz, nc, H, Q, P)
    for k in range(cluster):
        h = torch.zeros(Bsz, H, N, P)
        for j in range(k):
            h = D[j].exp()[..., None, None] * h + hloc[j]
        for c in range(bounds[k], bounds[k + 1]):
            inter = product(Cc[:, c], h, scheme) * s[:, c].exp()[..., None]
            y[:, c] = inter + product(M[:, c], xc[:, c], scheme)
            h = decay[:, c] * h + st[:, c]
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, nc * Q, H, P)[:, :S0]
    return y, h


def _inputs(B, S, H, P, N, seed):
    """tests/test_kernels.py's ``_ssd_inputs``, as torch tensors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.abs(rng.standard_normal((B, S, H))) * 0.1
    A = -(np.abs(rng.standard_normal((H,))) + 0.1)
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, dt, A, Bm, Cm)]


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("cluster", [1, 2, 8])
@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_within_sweep_tolerance(case, cluster):
    B, S, H, P, N, chunk = case
    args = _inputs(B, S, H, P, N, seed=sum(case))
    y, h = emulate(*args, chunk=chunk, cluster=cluster)
    yr, hr = ref.ssd_ref(*args, chunk=chunk, return_final=True)
    assert y.shape == yr.shape and h.shape == hr.shape
    torch.testing.assert_close(y, yr, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(h, hr, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.fixture(scope="module")
def full_head():
    """One mamba2-130m head (P 64, N 128, chunk 64) at batch 1 over 4096
    steps (64 chunks), and the plain version's y and final state."""
    args = _inputs(1, 4096, 1, 64, 128, seed=5)
    return args, ref.ssd_ref(*args, chunk=64, return_final=True)


def test_3xtf32_within_full_width_limit(full_head):
    args, (yr, hr) = full_head
    y, h = emulate(*args, chunk=64, cluster=8)
    assert _rel(y, yr) <= FULL_TOL and _rel(h, hr) <= FULL_TOL


def test_1xtf32_misses_the_full_width_limit(full_head):
    """The guard on the design: one TF32 product per f32 product is
    about forty times too coarse."""
    args, (yr, hr) = full_head
    y, _ = emulate(*args, chunk=64, cluster=8, scheme="1x")
    assert _rel(y, yr) > 10 * FULL_TOL


def test_rounded_split_within_full_width_limit(full_head):
    """The flash kernel's split (round to nearest) at the same head: the
    kernel's truncation costs a factor of about two, not the limit."""
    args, (yr, hr) = full_head
    y, h = emulate(*args, chunk=64, cluster=8, scheme="3x-rn")
    assert _rel(y, yr) <= FULL_TOL and _rel(h, hr) <= FULL_TOL

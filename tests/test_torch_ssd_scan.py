"""The port's SSD scan on the CPU against the JAX package's.

The port's ``ssd_scan`` op on CPU tensors (the plain version, the
model's own ``ssd_chunked``, which pads ragged sequences) against the JAX package's
Pallas ``ssd_scan_kernel`` in interpret mode, at the reference's sweep
(``tests/test_kernels.py``) and at a sequence shorter than its chunk;
against the numpy per-step recurrence; and the CUDA wrapper's refusals.

Tolerances: 2e-4 relative and absolute against the Pallas kernel, the
reference's own sweep tolerance (the same float32 products summed in
another order, and the inter-chunk scan associated otherwise); 1e-4
against the float64 per-step recurrence, as the reference's oracle test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro_torch.kernels.ssd_scan import kernel, ops

# (B, S, H, P, N, chunk): tests/test_kernels.py's SSD_SWEEP, then S < chunk
SSD_SWEEP = [
    (1, 64, 2, 32, 16, 32),
    (2, 128, 4, 64, 32, 64),
    (1, 96, 2, 32, 16, 32),
    (2, 100, 3, 16, 8, 64),      # ragged: padding path
    (1, 256, 1, 64, 64, 64),
    (1, 37, 2, 16, 16, 64),      # shorter than one chunk: Q = S
]


def _ssd_inputs(B, S, H, P, N, seed=0):
    """tests/test_kernels.py's ``_ssd_inputs``, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.abs(rng.standard_normal((B, S, H))) * 0.1
    A = -(np.abs(rng.standard_normal((H,))) + 0.1)
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("case", SSD_SWEEP)
def test_ssd_scan_matches_the_pallas_kernel(case):
    B, S, H, P, N, chunk = case
    args = _ssd_inputs(B, S, H, P, N, seed=sum(case))
    yj, hj = jax_ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                          return_final=True, interpret=True)
    ops.reset_launch_counts()
    y, h = ops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk,
                        return_final=True)
    assert ops.launch_counts["ssd_scan"] == 1
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=2e-4,
                               atol=2e-4)
    only_y = ops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert torch.equal(only_y, y)


@pytest.mark.parametrize("chunk", [16, 32, 12])
def test_ssd_scan_matches_the_per_step_recurrence(chunk):
    """The reference's independent oracle (tests/test_kernels.py), with a
    ragged chunk (12) too."""
    B, S, H, P, N = 1, 32, 2, 8, 4
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, seed=3)
    y, hf = ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                         chunk=chunk, return_final=True)
    h = np.zeros((B, H, N, P))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        dA = np.exp(dt[:, t].astype(np.float64) * A)            # (B,H)
        dBx = np.einsum("bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        h = h * dA[..., None, None] + dBx
        ys[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], h)
    np.testing.assert_allclose(y.numpy(), ys, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hf.numpy(), h, rtol=1e-4, atol=1e-4)


def test_upper_triangle_never_overflows():
    """Steep decays make s_i - s_j huge above the diagonal; the plain
    version masks before ``exp``, so nothing is inf or nan."""
    x, dt, A, Bm, Cm = _ssd_inputs(1, 64, 2, 16, 16, seed=4)
    dt = dt * 1e3
    y, h = ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                        chunk=64, return_final=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())


def test_ssd_scan_is_forward_only():
    """As the reference's Pallas call (no VJP): the backward raises on the
    CPU too, where the plain version could differentiate."""
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(1, 16, 1, 8, 4, seed=0))
    x.requires_grad_(True)
    y = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    with pytest.raises(NotImplementedError, match="forward only"):
        y.sum().backward()


@pytest.mark.parametrize("P,N", [(8, 4), (64, 16), (128, 128), (32, 64)])
def test_kernel_wrapper_refuses_unbuilt_shapes(P, N):
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(1, 64, 2, P, N, seed=0))
    with pytest.raises(ValueError, match=r"not one of .*\(64, 128\)"):
        kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=64)


def test_kernel_wrapper_refuses_cpu_tensors_of_built_shapes():
    for P, N in kernel.SHAPES:
        args = map(torch.from_numpy, _ssd_inputs(1, 64, 1, P, N, seed=0))
        with pytest.raises(ValueError, match="CUDA"):
            kernel.ssd_scan(*args, chunk=64)
    assert kernel.ssd_scan.launches == 0

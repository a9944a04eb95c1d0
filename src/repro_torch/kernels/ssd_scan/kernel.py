"""Build, binding and wrapper of the hand-written CUDA SSD-scan kernel
(``csrc/ssd_scan.cu``), which replaces the JAX package's Pallas
``ssd_scan_kernel``.

The source is built on first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a``, keyed by a hash of the source and the flags,
loaded with ``ctypes``); nothing is compiled or loaded at import time.

:func:`ssd_scan` checks its CUDA tensors, allocates y and the final
state, launches on the current stream without synchronising, raises when
the C entry reports a CUDA error, and counts its launches in a plain
integer (``ssd_scan.launches``).  Padding a ragged sequence is the op's
work (:mod:`.ops`); the plain version for CPU tensors is in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build

# (P, N) pairs the kernel is compiled for: the reference's sweep, the
# smoke configs, mamba2-130m (64, 128) and zamba2-2.7b (64, 64)
SHAPES = ((16, 8), (16, 16), (32, 16), (64, 32), (64, 64), (64, 128))
MAX_CHUNK = 64
MAX_CLUSTER = 8           # blocks per (head, batch row): csrc CLMAX
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = _build.Library(
    "ssd_scan",
    Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
    {"ssd_scan_f32": [_P] * 7 + [_I] * 7 + [_P]})


def cluster_size(B: int, H: int, n_chunks: int, n_sms: int) -> int:
    """Blocks per (head, batch row): the smallest power of two, at most
    ``MAX_CLUSTER`` and the number of chunks, that gives every SM a
    block."""
    cl = 1
    while cl < MAX_CLUSTER and B * H * cl < n_sms and 2 * cl <= n_chunks:
        cl *= 2
    return cl


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm, Cm: (B,S,N): contiguous
    float32 CUDA tensors on one device, S a multiple of ``chunk`` (at
    most 64).  Each (head, batch row)'s chunks are split over
    :func:`cluster_size` blocks.  Returns (y (B,S,H,P), final state
    (B,H,N,P)), float32."""
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"ssd_scan: x must be 4-d and Bm 3-d, not "
                         f"{x.dim()}-d and {Bm.dim()}-d")
    B, S, H, P = x.shape
    N = Bm.shape[2]
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan: (P, N) = {(P, N)} is not one of "
                         f"{SHAPES}, the pairs the kernel is built for")
    f32 = torch.float32
    _build.check("x", x, dtype=f32)
    dev = x.device
    _build.check("dt", dt, dtype=f32, shape=(B, S, H), device=dev)
    _build.check("A", A, dtype=f32, shape=(H,), device=dev)
    _build.check("Bm", Bm, dtype=f32, shape=(B, S, N), device=dev)
    _build.check("Cm", Cm, dtype=f32, shape=(B, S, N), device=dev)
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must be in [1, "
                         f"{MAX_CHUNK}] and divide S = {S}")
    if min(B, H) == 0 or max(B, H) > 65535:
        raise ValueError(f"ssd_scan: batch {B} and heads {H} must be in "
                         "[1, 65535]")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cluster = cluster_size(B, H, S // chunk, sms)
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} must start 16-byte aligned")
    y = torch.empty((B, S, H, P), dtype=f32, device=dev)
    h = torch.empty((B, H, N, P), dtype=f32, device=dev)
    fn = LIBRARY.entry("ssd_scan_f32")
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, H, P, N,
                chunk, cluster, torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.raise_on(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0

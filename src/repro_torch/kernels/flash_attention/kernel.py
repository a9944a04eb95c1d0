"""Build, binding and wrapper of the hand-written CUDA flash-attention
kernel (``csrc/flash_attention.cu``), which replaces the JAX package's
Pallas ``flash_attention_kernel``.

The source is built on first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a``, keyed by a hash of the source and the flags,
loaded with ``ctypes``); nothing is compiled or loaded at import time.
It is built with FMA contraction on (nvcc's default): the kernel's
products run on the tensor cores (3xTF32 for float32 inputs, which keeps
float32 accuracy; bf16 products for bfloat16), its softmax in float32 on
the CUDA cores, and it agrees with the plain version within 2e-5 in
float32 without ``-fmad=false``.

:func:`flash_attention` checks its CUDA tensors, allocates the output,
launches on the current stream without synchronising, raises when the C
entry reports a CUDA error, and counts its launches in a plain integer
(``flash_attention.launches``).  The plain version for CPU tensors is in
:mod:`.ref`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 80, 128, 256)   # head dims the kernel is compiled for
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 5 + [_I] * 6 + [_L] * 12
             + [ctypes.c_float, _I, _P])
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
LIBRARY = _build.Library(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {f"flash_attention_{s}": _ARGTYPES for s in _SUFFIX.values()})


def tf32_tile(h: int) -> int:
    """Keys per K/V tile of the float32 kernel (``Tf32Cfg<H>::BK``): 16 at
    h = 256, whose Q planes live in shared memory beside one tile."""
    return 16 if h > 128 else 32 if h == 128 else 64


def _aligned(t: torch.Tensor) -> bool:
    # the kernel copies rows to shared memory 16 bytes at a time (cp.async)
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and all(s % per == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, softmax_scale: float) -> torch.Tensor:
    """q: (B, nq, Sq, h); k, v: (B, nkv, Sk, h) CUDA tensors, f32 or
    bf16, any strides whose last is 1 (the models' (B, S, heads, h)
    tensors transposed are views, not copies).  Returns (B, nq, Sq, h)
    in q's dtype: a transposed view of a (B, Sq, nq, h) tensor, so the
    models' layout needs no copy on the way back either."""
    _build.check_cuda("q", q, ndim=4)
    dt, dev = q.dtype, q.device
    if dt not in _SUFFIX:
        raise TypeError(f"flash attention takes float32 or bfloat16, not {dt}")
    B, nq, Sq, h = q.shape
    _build.check_cuda("k", k, dtype=dt, ndim=4, device=dev)
    nkv, Sk = k.shape[1], k.shape[2]
    _build.check_cuda("v", v, dtype=dt, shape=k.shape, device=dev)
    if k.shape[0] != B or k.shape[3] != h:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head dim")
    if h not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {h} is not one of "
                         f"{HEAD_DIMS}, the dims the kernel is built for")
    if nq % nkv:
        raise ValueError(f"flash attention: nq={nq} is not a multiple of "
                         f"nkv={nkv}")
    if min(B, nq, Sq, Sk) == 0 or max(B, nq) > 65535:
        raise ValueError(f"flash attention: batch {B} and heads {nq} must be "
                         f"in [1, 65535] and sequences non-empty")
    out = torch.empty((B, Sq, nq, h), dtype=dt, device=dev).transpose(1, 2)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            raise ValueError(f"flash attention: {name} must have unit last "
                             "stride, other strides a multiple of 16 bytes "
                             "and a 16-byte aligned start")
    fn = LIBRARY.entry(f"flash_attention_{_SUFFIX[dt]}")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    work = None
    if dt == torch.float32:         # the K/V tiles' TF32 planes
        bk = tf32_tile(h)
        work = torch.empty(B * nkv * -(-Sk // bk) * 4 * bk * h,
                           dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _build.ptr(work), B, nq, nkv, Sq, Sk, h, *strides,
                float(softmax_scale),
                int(bool(causal)), torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.raise_on(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

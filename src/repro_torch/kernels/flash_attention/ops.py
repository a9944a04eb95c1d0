"""Public flash-attention op: the models' layout, the block contract,
dispatch and launch counting.

``flash_attention(q, k, v)`` takes the models' ``(B, S, heads, h)``
layout and returns the same layout.  CUDA tensors go to the hand-written
kernel in :mod:`.kernel` (as transposed views: nothing is copied), CPU
tensors to the plain version in :mod:`.ref`; there is no other branch.

It keeps the shape contract of the JAX package's op: ``nq % nkv == 0``,
``Sq % min(block_q, Sq) == 0`` and ``Sk % min(block_k, Sk) == 0``, and
raises ``ValueError`` where that kernel asserts.  It is forward only, as
the reference is (its Pallas call has no VJP): the op is an autograd
function whose backward raises ``NotImplementedError`` on both devices,
so the CPU path does not quietly differentiate the plain version where
the card cannot.

Every call bumps ``launch_counts["flash_attention"]`` and calls the
monkeypatchable ``on_launch`` hook once, the seam of
``detect_fused/ops.py``.
"""
from __future__ import annotations

import collections
from typing import Callable, Optional

import torch

from repro_torch.kernels.flash_attention import kernel, ref

launch_counts: collections.Counter = collections.Counter()
on_launch: Optional[Callable[[str], None]] = None


def _note_launch(name: str) -> None:
    launch_counts[name] += 1
    hook = on_launch
    if hook is not None:
        hook(name)


def reset_launch_counts() -> None:
    launch_counts.clear()


class _FlashAttention(torch.autograd.Function):
    """Forward on the kernel's (B, heads, S, h) views; no backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.is_cuda:
            return kernel.flash_attention(q, k, v, causal=causal,
                                          softmax_scale=scale)
        return ref.attention(q, k, v, causal=causal, softmax_scale=scale)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash_attention is forward only, as the JAX package's Pallas "
            "kernel is; train through use_kernels=False")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: (B, Sq, nq, h); k, v: (B, Sk, nkv, h) -> (B, Sq, nq, h)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d "
                         "(B, S, heads, h)")
    Sq, nq, h = q.shape[1], q.shape[2], q.shape[3]
    Sk, nkv = k.shape[1], k.shape[2]
    if Sq == 0 or Sk == 0:
        raise ValueError("flash_attention: empty sequence")
    if nq % nkv:
        raise ValueError(f"flash_attention: nq={nq} is not a multiple of "
                         f"nkv={nkv}")
    if Sq % min(block_q, Sq):
        raise ValueError(f"flash_attention: Sq={Sq} is not a multiple of "
                         f"block_q={min(block_q, Sq)}")
    if Sk % min(block_k, Sk):
        raise ValueError(f"flash_attention: Sk={Sk} is not a multiple of "
                         f"block_k={min(block_k, Sk)}")
    scale = softmax_scale if softmax_scale is not None else h ** -0.5
    _note_launch("flash_attention")
    out = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal, scale)
    return out.transpose(1, 2)

"""Public SSD-scan op: the reference's padding, dispatch and launch
counting.

``ssd_scan`` keeps the contract of the JAX package's op
(``src/repro/kernels/ssd_scan/ops.py``): the chunk is ``Q = min(chunk,
S)``, and a sequence that is not a multiple of ``Q`` is padded with
``dt = 0`` steps (``exp(0·A) = 1``: state-neutral) before the scan and
cut back after it.  CUDA tensors are padded here and go to the
hand-written kernel in :mod:`.kernel`; CPU tensors go to the plain
version in :mod:`.ref`, which pads the same way itself; there is no
other branch.  It is forward only, as the reference is (its Pallas call
has no VJP): the scan is an autograd function whose backward raises
``NotImplementedError`` on both devices, so the CPU path does not
quietly differentiate the plain version where the card cannot.  Every
call bumps ``launch_counts["ssd_scan"]``.
"""
from __future__ import annotations

import collections
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import kernel, ref

launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


class _SSDScan(torch.autograd.Function):
    """The scan at chunk ``Q = min(chunk, S)``; no backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        if not x.is_cuda:
            return ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk,
                               return_final=True)
        S = x.shape[1]
        Q = min(chunk, S)
        pad = (-S) % Q
        if pad:                   # dt = 0 -> exp(0·A) = 1: state-neutral
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        y, h = kernel.ssd_scan(x.contiguous(), dt.contiguous(),
                               A.contiguous(), Bm.contiguous(),
                               Cm.contiguous(), chunk=Q)
        return y[:, :S], h

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "ssd_scan is forward only, as the JAX package's Pallas kernel "
            "is; train through use_kernels=False")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64,
             return_final: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm, Cm: (B,S,N).  Returns y
    (B,S,H,P) f32 [, final state (B,H,N,P) f32]."""
    launch_counts["ssd_scan"] += 1
    y, h = _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
    return (y, h) if return_final else y

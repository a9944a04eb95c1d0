"""The plain PyTorch version of the SSD chunked-scan kernel.

Delegates to the model's own chunked SSD implementation
(:func:`repro_torch.models.mamba2.ssd_chunked`), as the JAX package's
``src/repro/kernels/ssd_scan/ref.py`` does: a single source of the SSD
semantics, h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t · h_t.

The wrapper in :mod:`.ops` runs it for CPU tensors; ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold the CUDA kernel against it on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.models.mamba2 import ssd_chunked


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 64,
            return_final: bool = False):
    """x: (B,S,H,P); dt: (B,S,H) post-softplus; A: (H,) negative;
    Bm, Cm: (B,S,N).  Returns y (B,S,H,P) [, final state (B,H,N,P)]."""
    return ssd_chunked(x.float(), dt.float(), A.float(), Bm.float(),
                       Cm.float(), chunk, return_final=return_final)

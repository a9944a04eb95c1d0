"""The plain PyTorch version of the flash-attention kernel.

Computes what the JAX package's Pallas kernel ``_attn_kernel``
(``src/repro/kernels/flash_attention/kernel.py:34``) computes, in its
``(B, heads, S, h)`` layout, on the whole score matrix at once: inputs
upcast to float32, query head ``qh`` reads KV head ``qh // group``,
scores scaled by ``softmax_scale``, causal entries ``col > row`` set to
``NEG_INF`` (not ``-inf``, so a row's ``exp`` underflows as the kernel's
does), softmax by max, ``exp`` and sum in float32, output ``acc / l``
with rows where ``l == 0`` giving ``acc`` (that is 0), cast back to the
input dtype once.

The wrapper in :mod:`.ops` runs it for CPU tensors; ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold the CUDA kernel against it on the
card.  Nothing on the card's path calls it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, softmax_scale: float) -> torch.Tensor:
    """q: (B, nq, Sq, h); k, v: (B, nkv, Sk, h) -> (B, nq, Sq, h)."""
    B, nq, Sq, h = q.shape
    nkv, Sk = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, nkv, g, Sq, h).float()
    s = torch.einsum("bkgsh,bkth->bkgst", qg, k.float()) * softmax_scale
    if causal:      # s is this function's own: masked and exp'd in place
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s.masked_fill_(cols > rows, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgst,bkth->bkgsh", p, v.float())
    out = acc / torch.where(l > 0.0, l, torch.ones_like(l))
    return out.reshape(B, nq, Sq, h).to(q.dtype)

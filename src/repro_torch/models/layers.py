"""Shared neural-net primitives: norms, rotary embeddings, MLP variants,
embedding and chunked cross-entropy.

Weights keep the JAX package's ``(in, out)`` layout: a projection is
``x @ w``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import scan
from repro_torch.models.params import P


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + weight`` (zero-initialised)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float,
                     dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions...) -> cos/sin of shape positions.shape + (head_dim//2,)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); cos/sin: (..., S, head_dim//2).
    Rotates the two halves of the head (not interleaved pairs)."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :].float()               # broadcast over heads
    s = sin[..., None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(dt)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict[str, P]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": P((d, f), ("embed", "mlp")),
            "w_up": P((d, f), ("embed", "mlp")),
            "w_down": P((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": P((d, f), ("embed", "mlp")),
        "w_down": P((f, d), ("mlp", "embed")),
    }


def mlp_apply(cfg: ArchConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    w_up = p["w_up"]
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ w_up)
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ w_up)
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(x @ w_up))
    else:  # gelu
        h = F.gelu(x @ w_up, approximate="tanh")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding with chunked cross-entropy
# ---------------------------------------------------------------------------

def embed_specs(cfg: ArchConfig) -> Dict[str, P]:
    specs = {"embedding": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                            init="embed")}
    if not cfg.tie_embeddings:
        specs["unembed"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return specs


def embed_tokens(p: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["embedding"])


def unembed_matrix(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return p["unembed"] if "unembed" in p else p["embedding"].T


def logits_for(p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    return h @ unembed_matrix(p)


def chunked_cross_entropy(p: Dict[str, torch.Tensor], hidden: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor,
                          chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materializing (B, S, V): a loop over sequence
    chunks of ``chunk`` positions (:func:`~repro_torch.core.psg.scan`,
    named ``loss_chunks``), each a float32 logsumexp, summed in chunk
    order with the remainder chunk added last, outside the loop.

    Returns (sum_loss, sum_count) as float32 scalars; caller divides.
    """
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    n = S // chunk
    rem = S - n * chunk
    w = unembed_matrix(p)

    def one(h_c, y_c, m_c):
        logits = (h_c @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
        losses = (lse - picked) * m_c
        return torch.sum(losses), torch.sum(m_c)

    def body(carry, xs):
        l, c = one(*xs)
        return (carry[0] + l, carry[1] + c), None

    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    chunks = [(hidden[:, s], labels[:, s], mask[:, s])
              for s in (slice(i * chunk, (i + 1) * chunk) for i in range(n))]
    (loss, count), _ = scan(body, (zero, zero), chunks, name="loss_chunks")
    if rem:
        s = slice(n * chunk, S)
        l, c = one(hidden[:, s], labels[:, s], mask[:, s])
        loss, count = loss + l, count + c
    return loss, count

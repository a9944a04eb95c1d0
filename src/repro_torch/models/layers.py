"""Shared neural-net primitives: norms, rotary embeddings, MLP variants,
embedding and chunked cross-entropy.

Weights keep the JAX package's ``(in, out)`` layout: a projection is
``x @ w``.

Under a ``model`` axis (:mod:`repro_torch.distributed.axes`) a rank holds
its shards, split as the reference's rules split them: the MLP's
``w_gate``/``w_up`` by columns and ``w_down`` by rows (one all-reduce),
the embedding by ``vocab`` rows (ids outside the rank's range give zero,
one all-reduce), and the unembedding by ``vocab`` columns, whose
cross-entropy is a vocab-parallel logsumexp per chunk (an all-reduce of
the max, of the sum of exponentials and of the picked logit).  The
embedding helpers take the config for that (``cfg=``); without it, or
where the rules leave a weight whole, they are the one-card code.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import scan
from repro_torch.distributed import axes as ax
from repro_torch.models.params import P


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             sp: bool = False) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + weight`` (zero-initialised).
    ``sp``: ``x`` is the rank's seq slice, so the gradient of the
    (replicated) weight is summed over ``model``."""
    if sp:
        weight = ax.copy_to_model(weight)
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
              x: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """The MLP; column- then row-parallel where the rules split ``mlp``
    (``sp``: ``x`` and the output are the rank's seq slices)."""
    tp = ax.model_dim(("embed", "mlp"), (cfg.d_model, cfg.d_ff)) is not None
    x = ax.enter_parallel(x, sp) if tp else ax.whole_seq(x, sp)
    w_up = p["w_up"]
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ w_up)
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ w_up)
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(x @ w_up))
    else:  # gelu
        h = F.gelu(x @ w_up, approximate="tanh")
    y = h @ p["w_down"]
    return ax.leave_parallel(y, sp) if tp else ax.own_seq(y, sp)


# ---------------------------------------------------------------------------
# Embedding / unembedding with chunked cross-entropy
# ---------------------------------------------------------------------------

def embed_specs(cfg: ArchConfig) -> Dict[str, P]:
    specs = {"embedding": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                            init="embed")}
    if not cfg.tie_embeddings:
        specs["unembed"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return specs


def vocab_shard(cfg: Optional[ArchConfig]) -> Optional[Tuple[int, int]]:
    """(first id, count) of this rank's ``vocab`` shard where the rules
    split the vocabulary on ``model``, else None."""
    if cfg is None or ax.model_dim(("vocab", "embed"),
                                   (cfg.vocab_size, cfg.d_model)) is None:
        return None
    n = cfg.vocab_size // ax.model_size()
    return ax.model_rank() * n, n


def embed_tokens(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 cfg: Optional[ArchConfig] = None,
                 sp: bool = False) -> torch.Tensor:
    """The tokens' embeddings (``sp``: the rank's seq slice of them)."""
    shard = vocab_shard(cfg)
    if shard is None:
        return ax.own_seq(F.embedding(tokens, p["embedding"]), sp)
    v0, n = shard
    mine = (tokens >= v0) & (tokens < v0 + n)
    x = F.embedding(torch.where(mine, tokens - v0, 0), p["embedding"])
    return ax.leave_parallel(x * mine[..., None].to(x.dtype), sp)


def unembed_matrix(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return p["unembed"] if "unembed" in p else p["embedding"].T


def logits_for(p: Dict[str, torch.Tensor], h: torch.Tensor,
               cfg: Optional[ArchConfig] = None) -> torch.Tensor:
    """Every id's logit (the ranks' ``vocab`` columns gathered)."""
    logits = h @ unembed_matrix(p)
    if vocab_shard(cfg) is None:
        return logits
    return ax.gather_from_model(logits, logits.dim() - 1)


def chunked_cross_entropy(p: Dict[str, torch.Tensor], hidden: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor,
                          chunk: int, cfg: Optional[ArchConfig] = None,
                          sp: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materializing (B, S, V): a loop over sequence
    chunks of ``chunk`` positions (:func:`~repro_torch.core.psg.scan`,
    named ``loss_chunks``), each a float32 logsumexp, summed in chunk
    order with the remainder chunk added last, outside the loop.  Where
    the rules split ``vocab`` (``cfg`` given), each chunk's logsumexp and
    picked logit are the vocab-parallel ones.  ``sp``: ``hidden`` is the
    rank's seq slice, gathered here (``labels`` and ``mask`` are whole).

    Returns (sum_loss, sum_count) as float32 scalars; caller divides.
    """
    w = unembed_matrix(p)
    shard = vocab_shard(cfg)
    hidden = (ax.enter_parallel(hidden, sp) if shard is not None
              else ax.whole_seq(hidden, sp))
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    n = S // chunk
    rem = S - n * chunk

    def lse_picked(logits, y_c):
        if shard is None:
            return (torch.logsumexp(logits, dim=-1),
                    torch.gather(logits, -1, y_c[..., None].long())[..., 0])
        v0, nv = shard
        top = ax.all_reduce_max(torch.amax(logits.detach(), dim=-1))
        total = ax.reduce_from_model(
            torch.sum(torch.exp(logits - top[..., None]), dim=-1))
        mine = (y_c >= v0) & (y_c < v0 + nv)
        local = torch.where(mine, y_c - v0, 0)
        picked = torch.gather(logits, -1, local[..., None].long())[..., 0]
        picked = ax.reduce_from_model(picked * mine.to(picked.dtype))
        return torch.log(total) + top, picked

    def one(h_c, y_c, m_c):
        logits = (h_c @ w).float()
        lse, picked = lse_picked(logits, y_c)
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

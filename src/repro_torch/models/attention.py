"""GQA/MQA/MHA attention: training (causal), prefill, and cached decode.

The einsum formulation below is the plain path; the hand-written CUDA
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`) is
the training path's drop-in behind ``cfg.use_kernels``.

The JAX package's sharding hints (``logical_constraint``,
``weight_constraint``) are identities under a data-parallel mesh and are
left out; they come back with tensor parallelism (ROADMAP Queue 1 item
10b).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import scan
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rotary, rotary_embedding
from repro_torch.models.params import P

NEG_INF = -1e30


def attention_specs(cfg: ArchConfig) -> Dict[str, P]:
    d, h = cfg.d_model, cfg.resolved_head_dim()
    return {
        "wq": P((d, cfg.n_heads * h), ("embed", "q_features")),
        "wk": P((d, cfg.n_kv_heads * h), ("embed", "kv_features")),
        "wv": P((d, cfg.n_kv_heads * h), ("embed", "kv_features")),
        "wo": P((cfg.n_heads * h, d), ("q_features", "embed")),
    }


def qkv(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
        positions: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,nq,h), k/v (B,S,nkv,h), rotary applied."""
    B, S, _ = x.shape
    h = cfg.resolved_head_dim()
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, h)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, h)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, h)
    cos, sin = rotary_embedding(positions, h, cfg.rope_theta, x.dtype)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor], *,
               softmax_scale: float) -> torch.Tensor:
    """Grouped-query attention core.

    q: (B, Sq, nq, h);  k, v: (B, Sk, nkv, h);  mask: broadcastable to
    (B, nkv, g, Sq, Sk) or None.  Scores in float32; the softmax weights
    are cast to ``q.dtype`` before the PV product.  Returns (B, Sq, nq, h).
    """
    B, Sq, nq, h = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, Sq, nkv, g, h)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) * softmax_scale
    if mask is not None:
        scores.masked_fill_(~mask, NEG_INF)      # scores is ours: in place
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, Sq, nq, h)


def causal_mask(Sq: int, Sk: int, device=None) -> torch.Tensor:
    """(1, 1, 1, Sq, Sk) causal mask: key t is seen by query s iff t <= s."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    return (kpos <= qpos)[None, None, None]


CHUNKED_ATTN_THRESHOLD = 2048     # switch to O(S·BQ) attention above this


def chunked_gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, softmax_scale: float,
                       q_chunk: int = 512) -> torch.Tensor:
    """Memory-efficient attention: a loop over query blocks.

    The plain einsum path materializes (B, nkv, g, Sq, Sk) scores; a loop
    over query blocks keeps only (B, nkv, g, BQ, Sk) live.  Numerics match
    :func:`gqa_attend` (float32 softmax over the full key axis, weights
    cast to ``q.dtype``).  Each block is checkpointed, as the JAX
    package's per-chunk remat: without it the backward saves softmax
    weights for every block, the quadratic matrix the loop exists to
    avoid.
    """
    B, Sq, nq, h = q.shape
    nkv, Sk = k.shape[2], k.shape[1]
    g = nq // nkv
    BQ = min(q_chunk, Sq)
    while Sq % BQ:
        BQ -= 1
    kf = k.float()
    cols = torch.arange(Sk, device=q.device)[None, :]

    def chunk(_, xs):
        qi, blk = xs
        scores = torch.einsum("bskgh,btkh->bkgst",
                              blk.reshape(B, BQ, nkv, g, h).float(),
                              kf) * softmax_scale
        if causal:
            rows = qi * BQ + torch.arange(BQ, device=q.device)[:, None]
            scores.masked_fill_((cols > rows)[None, None, None], NEG_INF)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return None, torch.einsum("bkgst,btkh->bskgh", w, v)

    blocks = [(qi, q[:, qi * BQ:(qi + 1) * BQ]) for qi in range(Sq // BQ)]
    _, outs = scan(chunk, None, blocks, name="attn_chunks", remat=True)
    return torch.cat(outs, dim=1).reshape(B, Sq, nq, h)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, softmax_scale: float) -> torch.Tensor:
    """Quadratic einsum path up to the threshold, chunked above it."""
    Sq, Sk = q.shape[1], k.shape[1]
    if max(Sq, Sk) > CHUNKED_ATTN_THRESHOLD:
        return chunked_gqa_attend(q, k, v, causal=causal,
                                  softmax_scale=softmax_scale)
    mask = causal_mask(Sq, Sk, device=q.device) if causal else None
    return gqa_attend(q, k, v, mask, softmax_scale=softmax_scale)


def attention_train(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = qkv(cfg, p, x, positions)
    scale = cfg.resolved_head_dim() ** -0.5
    if cfg.use_kernels:
        out = flash_attention(q, k, v, causal=causal, softmax_scale=scale)
    else:
        out = attend(q, k, v, causal=causal, softmax_scale=scale)
    return out.reshape(B, S, -1) @ p["wo"]


def cross_attention_train(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                          x: torch.Tensor,
                          kv_src: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over the encoder output (no rotary, no
    mask), by ``gqa_attend`` whatever ``cfg.use_kernels`` says, as in the
    reference."""
    B, S, _ = x.shape
    T = kv_src.shape[1]
    h = cfg.resolved_head_dim()
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, h)
    k = (kv_src @ p["wk"]).reshape(B, T, cfg.n_kv_heads, h)
    v = (kv_src @ p["wv"]).reshape(B, T, cfg.n_kv_heads, h)
    out = gqa_attend(q, k, v, None, softmax_scale=h ** -0.5)
    return out.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (n_layers, B, S_max, n_kv, h)
    v: torch.Tensor       # (n_layers, B, S_max, n_kv, h)
    length: torch.Tensor  # (B,) int32 — tokens already cached


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, n_layers: int,
                  dtype: torch.dtype, device) -> KVCache:
    h = cfg.resolved_head_dim()
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, h)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def attention_decode(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); caches (B, S_max, n_kv, h).

    The new K/V are written into the caches in place, at position
    ``lengths`` of each row; a row whose cache is full is left as it is.
    That is the JAX package's one-hot blend without rewriting every slot:
    the same cache values, one slot a row written.  A caller that keeps
    the caches from before the step still reads them right, as that slot
    lies past its length and is written again before it is read.  The
    query sees positions ``<= lengths``.
    Returns (out (B,1,D), k_cache, v_cache).
    """
    B, one, _ = x.shape
    S_max = k_cache.shape[1]
    positions = lengths[:, None]                                    # (B, 1)
    q, k, v = qkv(cfg, p, x, positions)
    rows = torch.arange(B, device=x.device)
    slot = lengths.clamp(max=S_max - 1).long()
    full = (lengths >= S_max)[:, None, None]
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[rows, slot] = torch.where(full, cache[rows, slot],
                                        new[:, 0].to(cache.dtype))
    slots = torch.arange(S_max, device=x.device)[None, :]
    valid = slots <= lengths[:, None]                               # (B, S_max)
    mask = valid[:, None, None, None, :]                            # b k g s t
    out = gqa_attend(q, k_cache, v_cache, mask,
                     softmax_scale=cfg.resolved_head_dim() ** -0.5)
    out = out.reshape(B, one, -1) @ p["wo"]
    return out, k_cache, v_cache

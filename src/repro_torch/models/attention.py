"""GQA/MQA/MHA attention: training (causal), prefill, and cached decode.

The einsum formulation below is the plain path; the hand-written CUDA
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`) is
the training path's drop-in behind ``cfg.use_kernels``.

Under a ``model`` axis (:func:`heads`) a rank computes the query heads of
its ``wq`` columns and the K/V heads they read, and the output
projection's partial sums over its ``wo`` rows are all-reduced.  Where
``kv_features`` splits into whole K/V heads the rank holds those; where
it splits inside a head (n_kv_heads does not divide the axis) the
``wk``/``wv`` shards are gathered at use and every rank computes every
K/V head, its query heads reading theirs by global index.  Flash and the
plain path run on the local heads unchanged.  Under sequence parallelism
(``sp``) the input is the rank's seq slice, gathered before the
projections, and the output is reduce-scattered back to slices: the
attention itself always sees the whole sequence.

The decode cache's positions may be split (``kv_seq`` in the rules):
over ``model`` where the KV heads do not divide the axis (every rank
computes every K/V head and caches its slice of the positions), or over
the batch axes for long-context serving (one sequence across the batch
ranks).  Decode then writes the new token's K/V on the rank whose slice
holds its slot, and each rank attends over its positions: a flash-decode
partial softmax, the ranks' exp-sums and weighted values combined by an
all-reduce of the max and one of the sums (:func:`_partial_attend`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import scan
from repro_torch.distributed import axes as ax
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


class Heads(NamedTuple):
    """The attention heads one rank computes under the active rules."""
    tp: bool        # query heads split on the model axis
    nq: int         # query heads of this rank
    q0: int         # global index of its first
    nkv: int        # K/V heads it computes and caches
    kv: str         # "local": whole K/V heads of its own; "gather": wk/wv
    #                 split inside a head, gathered; "whole": not split


def heads(cfg: ArchConfig) -> Heads:
    """This rank's heads: every head without a ``model`` axis; else the
    query heads of its ``q_features`` shard and the K/V heads of its
    ``kv_features`` shard, or every K/V head where those do not split
    into whole heads."""
    d, h = cfg.d_model, cfg.resolved_head_dim()
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    qd = ax.model_dim(("embed", "q_features"), (d, nq * h))
    kd = ax.model_dim(("embed", "kv_features"), (d, nkv * h))
    if qd is None:
        if kd is not None:
            raise NotImplementedError(
                "whole query heads with split K/V heads: no config of the "
                "production meshes asks for it")
        return Heads(False, nq, 0, nkv, "whole")
    m = ax.model_size()
    if nq % m:
        raise NotImplementedError(
            f"{nq} query heads on a model axis of {m}: a head split inside "
            "a head, which no config of the production meshes asks for")
    local = nq // m
    if kd is not None and nkv % m == 0:
        return Heads(True, local, ax.model_rank() * local, nkv // m, "local")
    return Heads(True, local, ax.model_rank() * local, nkv,
                 "gather" if kd is not None else "whole")


def kv_weights(cfg: ArchConfig, p: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wk`` and ``wv`` of the K/V heads this rank computes: its shards,
    the shards gathered where they split inside a head, or the whole
    weights, whose gradient each rank only has its query heads' part of."""
    hd = heads(cfg)
    wk, wv = p["wk"], p["wv"]
    if hd.tp and hd.kv == "gather":
        return ax.gather_from_model(wk, 1), ax.gather_from_model(wv, 1)
    if hd.tp and hd.kv == "whole":
        return ax.copy_to_model(wk), ax.copy_to_model(wv)
    return wk, wv


def qkv(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
        positions: Optional[torch.Tensor], sp: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,nq,h), k/v (B,S,nkv,h), rotary applied:
    this rank's query heads and the K/V heads it computes (:func:`heads`).
    ``sp``: x is the rank's seq slice (q, k and v are of the whole
    sequence).  ``positions`` None means ``0 .. S - 1``."""
    h = cfg.resolved_head_dim()
    hd = heads(cfg)
    x = ax.enter_parallel(x, sp) if hd.tp else ax.whole_seq(x, sp)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    wk, wv = kv_weights(cfg, p)
    q = (x @ p["wq"]).reshape(B, S, hd.nq, h)
    k = (x @ wk).reshape(B, S, hd.nkv, h)
    v = (x @ wv).reshape(B, S, hd.nkv, h)
    cos, sin = rotary_embedding(positions, h, cfg.rope_theta, x.dtype)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def kv_for_heads(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V heads (dim 2) that this rank's query heads read, from the
    K/V heads it computes."""
    hd = heads(cfg)
    if hd.kv == "local" or not hd.tp:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    if hd.nq % g == 0:
        sl = slice(hd.q0 // g, (hd.q0 + hd.nq) // g)
    elif g % hd.nq == 0:
        sl = slice(hd.q0 // g, hd.q0 // g + 1)
    else:
        raise NotImplementedError(
            f"{hd.nq} query heads a rank in groups of {g}: no config of "
            "the production meshes asks for it")
    return k[:, :, sl], v[:, :, sl]


def out_proj(cfg: ArchConfig, p: Dict[str, torch.Tensor],
             out: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """(B, S, nq, h) -> (B, S, D): ``@ wo``, its partial sums over the
    ``model`` ranks' heads all-reduced (``sp``: reduce-scattered to the
    ranks' seq slices)."""
    B, S = out.shape[:2]
    y = out.reshape(B, S, -1) @ p["wo"]
    return ax.leave_parallel(y, sp) if heads(cfg).tp else ax.own_seq(y, sp)


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
                    x: torch.Tensor, *, causal: bool = True,
                    sp: bool = False) -> torch.Tensor:
    q, k, v = qkv(cfg, p, x, None, sp)
    k, v = kv_for_heads(cfg, k, v)
    scale = cfg.resolved_head_dim() ** -0.5
    if cfg.use_kernels:
        out = flash_attention(q, k, v, causal=causal, softmax_scale=scale)
    else:
        out = attend(q, k, v, causal=causal, softmax_scale=scale)
    return out_proj(cfg, p, out, sp)


def cross_attention_train(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                          x: torch.Tensor, kv_src: torch.Tensor,
                          sp: bool = False) -> torch.Tensor:
    """Decoder cross-attention over the encoder output (no rotary, no
    mask), by ``gqa_attend`` whatever ``cfg.use_kernels`` says, as in the
    reference.  On this rank's heads: both inputs enter column-parallel
    weights; ``kv_src`` is whole on every rank, ``x`` too or (``sp``) the
    rank's seq slice."""
    h = cfg.resolved_head_dim()
    hd = heads(cfg)
    x = ax.enter_parallel(x, sp) if hd.tp else ax.whole_seq(x, sp)
    if hd.tp:
        kv_src = ax.copy_to_model(kv_src)
    B, S, _ = x.shape
    T = kv_src.shape[1]
    wk, wv = kv_weights(cfg, p)
    q = (x @ p["wq"]).reshape(B, S, hd.nq, h)
    k = (kv_src @ wk).reshape(B, T, hd.nkv, h)
    v = (kv_src @ wv).reshape(B, T, hd.nkv, h)
    out = gqa_attend(q, *kv_for_heads(cfg, k, v), None,
                     softmax_scale=h ** -0.5)
    return out_proj(cfg, p, out, sp)


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (n_layers, B, S_max, n_kv, h)
    v: torch.Tensor       # (n_layers, B, S_max, n_kv, h)
    length: torch.Tensor  # (B,) int32 — tokens already cached


def cache_len(max_len: int) -> int:
    """The positions of a ``max_len`` cache that this rank holds: all of
    them, or its slice where the rules split ``kv_seq`` (which must then
    divide ``max_len``: a rank's slice has to be told from a whole cache
    by its rules, not by its length)."""
    _, n = ax.rule_axes("kv_seq")
    if max_len % n:
        raise ValueError(f"a cache of {max_len} positions does not split "
                         f"into the {n} parts the rules ask of kv_seq")
    return max_len // n


def _cache_slot0(max_len_local: int) -> int:
    """The global position of this rank's first cache slot."""
    axes, n = ax.rule_axes("kv_seq")
    return 0 if n == 1 else ax.group_of(axes)[2] * max_len_local


def cache_positions(t: torch.Tensor, max_len: int) -> torch.Tensor:
    """A prompt's K or V ``t`` (B, S, n_kv, h) as this rank's cache of
    ``max_len`` positions: zeros after position S, and where the rules
    split ``kv_seq`` only the rank's slice of the positions."""
    sl = cache_len(max_len)
    lo = _cache_slot0(sl)
    part = t[:, lo:lo + sl]
    return F.pad(part, (0, 0, 0, 0, 0, sl - part.shape[1]))


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, n_layers: int,
                  dtype: torch.dtype, device) -> KVCache:
    """Zero caches of the K/V heads this rank computes (:func:`heads`) and
    of its positions (:func:`cache_len`)."""
    h = cfg.resolved_head_dim()
    shape = (n_layers, batch, cache_len(max_len), heads(cfg).nkv, h)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def _partial_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, group, *,
                    softmax_scale: float) -> torch.Tensor:
    """GQA attention of q (B, Sq, nq, h) over this rank's slice of the
    keys (B, Sk, nkv, h), ``valid`` (B, Sk) its unmasked positions, the
    softmax taken over the positions of every rank of ``group``: the
    scores' max all-reduced, then the exp-sums and the weighted values in
    one all-reduce (float32).  Returns (B, Sq, nq, h) in q's dtype."""
    B, Sq, nq, h = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scores = torch.einsum("bskgh,btkh->bkgst",
                          q.reshape(B, Sq, nkv, g, h).float(),
                          k.float()) * softmax_scale
    scores.masked_fill_(~valid[:, None, None, None, :], NEG_INF)
    top = ax.all_reduce_max(torch.amax(scores, dim=-1), group)
    w = torch.exp(scores - top[..., None])                  # b k g s t
    o = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    l = torch.sum(w, dim=-1)                                # b k g s
    both = ax.all_reduce_sum(torch.cat([o.reshape(-1), l.reshape(-1)]),
                             group)
    o = both[:o.numel()].reshape(o.shape)
    l = both[o.numel():].reshape(l.shape).permute(0, 3, 1, 2)[..., None]
    return (o / l).reshape(B, Sq, nq, h).to(q.dtype)


def attention_decode(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); caches (B, S_max, n_kv, h), this
    rank's (:func:`init_kv_cache`).

    The new K/V are written into the caches in place, at position
    ``lengths`` of each row; a row whose cache is full is left as it is.
    That is the JAX package's one-hot blend without rewriting every slot:
    the same cache values, one slot a row written.  A caller that keeps
    the caches from before the step still reads them right, as that slot
    lies past its length and is written again before it is read.  The
    query sees positions ``<= lengths``.  Where the rules split the
    cache's positions, only the rank whose slice holds slot ``lengths``
    writes it, and the softmax is the ranks' partial ones combined
    (:func:`_partial_attend`); over ``model`` (the GQA fallback, every
    rank holding every K/V head) the token's query heads are gathered
    first and the rank keeps its own heads' output for ``wo``.
    Returns (out (B,1,D), k_cache, v_cache).
    """
    B = x.shape[0]
    sl = k_cache.shape[1]
    positions = lengths[:, None]                                    # (B, 1)
    q, k, v = qkv(cfg, p, x, positions)
    axes, n = ax.rule_axes("kv_seq")
    lo = _cache_slot0(sl)
    rows = torch.arange(B, device=x.device)
    slot = (lengths - lo).clamp(min=0, max=sl - 1).long()
    mine = ((lengths >= lo) & (lengths < lo + sl))[:, None, None]
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[rows, slot] = torch.where(mine, new[:, 0].to(cache.dtype),
                                        cache[rows, slot])
    slots = lo + torch.arange(sl, device=x.device)[None, :]
    valid = slots <= lengths[:, None]                        # (B, S_max)
    scale = cfg.resolved_head_dim() ** -0.5
    if n == 1:
        out = gqa_attend(q, *kv_for_heads(cfg, k_cache, v_cache),
                         valid[:, None, None, None, :], softmax_scale=scale)
        return out_proj(cfg, p, out), k_cache, v_cache
    hd = heads(cfg)
    group = ax.group_of(axes)[0]
    if "model" not in axes:          # long context: the rank's own heads
        out = _partial_attend(q, *kv_for_heads(cfg, k_cache, v_cache),
                              valid, group, softmax_scale=scale)
        return out_proj(cfg, p, out), k_cache, v_cache
    if hd.kv == "local":
        raise ValueError("a cache split on model positions needs every "
                         "K/V head on every rank (kv_heads whole)")
    if hd.tp:
        q = ax.gather_from_model(q, 2)
    out = _partial_attend(q, k_cache, v_cache, valid, group,
                          softmax_scale=scale)
    if hd.tp:
        out = out[:, :, hd.q0:hd.q0 + hd.nq]
    return out_proj(cfg, p, out), k_cache, v_cache

"""Encoder-decoder transformer backbone (seamless-m4t family).

The modality frontend is a stub: the encoder consumes precomputed frame
embeddings (B, T, D).  The decoder is a causal transformer with
cross-attention; decode caches both the self-attention K/V and each
layer's projected cross-attention K/V of the encoder output.

The encoder and decoder loops are :func:`repro_torch.core.psg.scan`
over the layers' views of the stacked parameters, each block
checkpointed under ``cfg.remat``, as the reference's ``lax.scan`` of a
``jax.checkpoint``-ed block.  Under ``cfg.use_kernels`` the encoder's
self-attention reaches the flash kernel non-causal and the decoder's
causal; cross-attention, and the decoder's self-attention in
``prefill`` and ``decode_step``, stay on the einsum path, as in the
reference.  Under a ``model`` axis every attention (self and cross) runs
on the rank's heads and caches its K/V heads, the MLPs on its columns;
the embedding and the loss are vocab-parallel where the vocabulary
divides the axis, else whole on every rank.  Under sequence parallelism
the encoder's and the decoder's residual streams are each split on seq
where their length divides the axis; the encoder's output is gathered
whole once, before the decoder's cross-attention reads it.  Under
``gather_weights`` a layer's leaves are gathered on ``data`` at the entry
of its loop body, the others at the entry of the model function.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import scan
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    chunked_cross_entropy,
    embed_specs,
    embed_tokens,
    logits_for,
    mlp_apply,
    mlp_specs,
    rms_norm,
)
from repro_torch.distributed import axes as ax
from repro_torch.models.params import P, Specs, gather_at_use
from repro_torch.models.transformer import (layer_params, stack_specs,
                                           unbind_layers)


def enc_layer_specs(cfg: ArchConfig) -> Specs:
    return {
        "attn_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "attn": attn.attention_specs(cfg),
        "mlp_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": mlp_specs(cfg),
    }


def dec_layer_specs(cfg: ArchConfig) -> Specs:
    return {
        "self_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "self_attn": attn.attention_specs(cfg),
        "cross_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "cross_attn": attn.attention_specs(cfg),
        "mlp_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": mlp_specs(cfg),
    }


_SKIP = ("encoder", "decoder")     # gathered a layer at a time


def encdec_specs(cfg: ArchConfig) -> Specs:
    return {
        "embed": embed_specs(cfg),
        "encoder": stack_specs(enc_layer_specs(cfg), cfg.enc_layers),
        "decoder": stack_specs(dec_layer_specs(cfg), cfg.n_layers),
        "enc_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "final_norm": P((cfg.d_model,), ("embed",), init="zeros"),
    }


def encode(cfg: ArchConfig, params: Dict[str, Any],
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, D) precomputed embeddings -> encoder output (B, T, D),
    whole on every rank (under sequence parallelism gathered from the
    ranks' slices)."""
    sp = ax.seq_parallel(frames.shape[1])
    eps = cfg.norm_eps

    def block(x, p):
        p = gather_at_use(p, enc_layer_specs, cfg)
        h = x + attn.attention_train(cfg, p["attn"],
                                     rms_norm(x, p["attn_norm"], eps, sp),
                                     causal=False, sp=sp)
        return h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"], eps,
                                                     sp), sp), None

    h, _ = scan(block, ax.own_seq(frames, sp),
                unbind_layers(params["encoder"], cfg.enc_layers),
                name="encoder", remat=cfg.remat)
    return ax.whole_seq(rms_norm(h, params["enc_norm"], eps, sp), sp)


def _dec_block_train(cfg: ArchConfig, enc_out: torch.Tensor, sp: bool,
                     x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    p = gather_at_use(p, dec_layer_specs, cfg)
    eps = cfg.norm_eps
    h = x + attn.attention_train(cfg, p["self_attn"],
                                 rms_norm(x, p["self_norm"], eps, sp), sp=sp)
    h = h + attn.cross_attention_train(
        cfg, p["cross_attn"], rms_norm(h, p["cross_norm"], eps, sp), enc_out,
        sp)
    return h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"], eps, sp),
                         sp)


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy of the decoder over
    ``batch["tokens"]`` (B, S + 1) given ``batch["frames"]`` (B, T, D);
    labels below 0 are masked out.  Returns (loss, metrics)."""
    params = gather_at_use(params, encdec_specs, cfg, skip=_SKIP)
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    enc_out = encode(cfg, params, batch["frames"].to(
        params["final_norm"].dtype))
    sp = ax.seq_parallel(inputs.shape[1])
    x = embed_tokens(params["embed"], inputs, cfg, sp)
    h, _ = scan(lambda x, p: (_dec_block_train(cfg, enc_out, sp, x, p),
                              None), x,
                unbind_layers(params["decoder"], cfg.n_layers),
                name="decoder", remat=cfg.remat)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps, sp)
    mask = (labels >= 0).float()
    loss_sum, count = chunked_cross_entropy(
        params["embed"], h, torch.clamp(labels, min=0), mask, cfg.loss_chunk,
        cfg, sp)
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"ce_loss": loss, "loss": loss, "tokens": count}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class EncDecCache(NamedTuple):
    self_kv: attn.KVCache      # (L, B, S_max, n_kv, h), the rank's K/V heads
    cross_k: torch.Tensor      # (L, B, T, n_kv, h): projected encoder output
    cross_v: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> EncDecCache:
    cross = (cfg.n_layers, batch, cfg.frontend_len, attn.heads(cfg).nkv,
             cfg.resolved_head_dim())
    return EncDecCache(
        attn.init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype, device),
        torch.zeros(cross, dtype=dtype, device=device),
        torch.zeros(cross, dtype=dtype, device=device))


def prefill(cfg: ArchConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], max_len: int
            ) -> Tuple[torch.Tensor, EncDecCache]:
    """Encode the frames and run the decoder over the prompt, priming the
    self K/V (``max_len`` positions, zeros after S) and each layer's
    projected cross K/V.  Returns (last-position logits, cache)."""
    params = gather_at_use(params, encdec_specs, cfg, skip=_SKIP)
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(cfg, params, batch["frames"].to(
        params["final_norm"].dtype))
    sp = ax.seq_parallel(S)
    eps = cfg.norm_eps
    x = embed_tokens(params["embed"], tokens, cfg, sp)
    hd = cfg.resolved_head_dim()
    nkv = attn.heads(cfg).nkv
    T = enc_out.shape[1]
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.n_layers):
        p = gather_at_use(layer_params(params["decoder"], i),
                          dec_layer_specs, cfg)
        xn = rms_norm(x, p["self_norm"], eps, sp)
        q, k, v = attn.qkv(cfg, p["self_attn"], xn, None, sp)
        o = attn.attend(q, *attn.kv_for_heads(cfg, k, v), causal=True,
                        softmax_scale=hd ** -0.5)
        h = x + attn.out_proj(cfg, p["self_attn"], o, sp)
        h = h + attn.cross_attention_train(
            cfg, p["cross_attn"], rms_norm(h, p["cross_norm"], eps, sp),
            enc_out, sp)
        x = h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"], eps, sp),
                          sp)
        ks.append(attn.cache_positions(k, max_len))
        vs.append(attn.cache_positions(v, max_len))
        wk, wv = attn.kv_weights(cfg, p["cross_attn"])
        cks.append((enc_out @ wk).reshape(B, T, nkv, hd))
        cvs.append((enc_out @ wv).reshape(B, T, nkv, hd))
    h = ax.whole_seq(rms_norm(x, params["final_norm"], eps, sp), sp)
    logits = logits_for(params["embed"], h[:, -1:, :], cfg)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, EncDecCache(
        attn.KVCache(torch.stack(ks), torch.stack(vs), lengths),
        torch.stack(cks), torch.stack(cvs))


def decode_step(cfg: ArchConfig, params: Dict[str, Any], cache: EncDecCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, EncDecCache]:
    """One decode step. tokens: (B, 1) int; returns (logits (B, 1, V),
    the cache one token longer).  Each layer's new self K/V is written into
    the cache's buffers in place (``attention_decode``); the cross K/V are
    read as they are."""
    params = gather_at_use(params, encdec_specs, cfg, skip=_SKIP)
    kv = cache.self_kv
    x = embed_tokens(params["embed"], tokens, cfg)
    hd = cfg.resolved_head_dim()
    nq = attn.heads(cfg).nq
    B = x.shape[0]
    for i in range(cfg.n_layers):
        p = gather_at_use(layer_params(params["decoder"], i),
                          dec_layer_specs, cfg)
        xn = rms_norm(x, p["self_norm"], cfg.norm_eps)
        o, _, _ = attn.attention_decode(cfg, p["self_attn"], xn, kv.k[i],
                                        kv.v[i], kv.length)
        h = x + o
        hn = rms_norm(h, p["cross_norm"], cfg.norm_eps)
        q = (hn @ p["cross_attn"]["wq"]).reshape(B, 1, nq, hd)
        co = attn.gqa_attend(q, *attn.kv_for_heads(cfg, cache.cross_k[i],
                                                   cache.cross_v[i]), None,
                             softmax_scale=hd ** -0.5)
        h = h + attn.out_proj(cfg, p["cross_attn"], co)
        x = h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"],
                                                  cfg.norm_eps))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h, cfg)
    return logits, cache._replace(self_kv=kv._replace(length=kv.length + 1))

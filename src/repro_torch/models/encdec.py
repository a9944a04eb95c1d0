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
reference.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

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
from repro_torch.models.params import P, Specs
from repro_torch.models.transformer import (layer_params, stack_specs,
                                           unbind_layers)


def encdec_specs(cfg: ArchConfig) -> Specs:
    enc_layer = {
        "attn_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "attn": attn.attention_specs(cfg),
        "mlp_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": mlp_specs(cfg),
    }
    dec_layer = {
        "self_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "self_attn": attn.attention_specs(cfg),
        "cross_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "cross_attn": attn.attention_specs(cfg),
        "mlp_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": mlp_specs(cfg),
    }
    return {
        "embed": embed_specs(cfg),
        "encoder": stack_specs(enc_layer, cfg.enc_layers),
        "decoder": stack_specs(dec_layer, cfg.n_layers),
        "enc_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "final_norm": P((cfg.d_model,), ("embed",), init="zeros"),
    }


def encode(cfg: ArchConfig, params: Dict[str, Any],
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, D) precomputed embeddings -> encoder output (B, T, D)."""
    def block(x, p):
        h = x + attn.attention_train(cfg, p["attn"],
                                     rms_norm(x, p["attn_norm"], cfg.norm_eps),
                                     causal=False)
        return h + mlp_apply(cfg, p["mlp"],
                             rms_norm(h, p["mlp_norm"], cfg.norm_eps)), None

    h, _ = scan(block, frames, unbind_layers(params["encoder"],
                                             cfg.enc_layers),
                name="encoder", remat=cfg.remat)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _dec_block_train(cfg: ArchConfig, enc_out: torch.Tensor, x: torch.Tensor,
                     p: Dict[str, Any]) -> torch.Tensor:
    h = x + attn.attention_train(cfg, p["self_attn"],
                                 rms_norm(x, p["self_norm"], cfg.norm_eps))
    h = h + attn.cross_attention_train(
        cfg, p["cross_attn"], rms_norm(h, p["cross_norm"], cfg.norm_eps),
        enc_out)
    return h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"],
                                                 cfg.norm_eps))


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy of the decoder over
    ``batch["tokens"]`` (B, S + 1) given ``batch["frames"]`` (B, T, D);
    labels below 0 are masked out.  Returns (loss, metrics)."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    enc_out = encode(cfg, params, batch["frames"].to(
        params["final_norm"].dtype))
    x = embed_tokens(params["embed"], inputs)
    h, _ = scan(lambda x, p: (_dec_block_train(cfg, enc_out, x, p), None), x,
                unbind_layers(params["decoder"], cfg.n_layers),
                name="decoder", remat=cfg.remat)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    mask = (labels >= 0).float()
    loss_sum, count = chunked_cross_entropy(
        params["embed"], h, torch.clamp(labels, min=0), mask, cfg.loss_chunk)
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"ce_loss": loss, "loss": loss, "tokens": count}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class EncDecCache(NamedTuple):
    self_kv: attn.KVCache      # (L, B, S_max, n_kv, h)
    cross_k: torch.Tensor      # (L, B, T, n_kv, h): projected encoder output
    cross_v: torch.Tensor


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> EncDecCache:
    cross = (cfg.n_layers, batch, cfg.frontend_len, cfg.n_kv_heads,
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
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(cfg, params, batch["frames"].to(
        params["final_norm"].dtype))
    x = embed_tokens(params["embed"], tokens)
    hd = cfg.resolved_head_dim()
    T = enc_out.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    pad = (0, 0, 0, 0, 0, max_len - S)          # zeros after position S
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["decoder"], i)
        xn = rms_norm(x, p["self_norm"], cfg.norm_eps)
        q, k, v = attn.qkv(cfg, p["self_attn"], xn, positions)
        o = attn.attend(q, k, v, causal=True, softmax_scale=hd ** -0.5)
        h = x + o.reshape(B, S, -1) @ p["self_attn"]["wo"]
        h = h + attn.cross_attention_train(
            cfg, p["cross_attn"], rms_norm(h, p["cross_norm"], cfg.norm_eps),
            enc_out)
        x = h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"],
                                                  cfg.norm_eps))
        ks.append(F.pad(k, pad))
        vs.append(F.pad(v, pad))
        cks.append((enc_out @ p["cross_attn"]["wk"])
                   .reshape(B, T, cfg.n_kv_heads, hd))
        cvs.append((enc_out @ p["cross_attn"]["wv"])
                   .reshape(B, T, cfg.n_kv_heads, hd))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h[:, -1:, :])
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
    kv = cache.self_kv
    x = embed_tokens(params["embed"], tokens)
    hd = cfg.resolved_head_dim()
    B = x.shape[0]
    for i in range(cfg.n_layers):
        p = layer_params(params["decoder"], i)
        xn = rms_norm(x, p["self_norm"], cfg.norm_eps)
        o, _, _ = attn.attention_decode(cfg, p["self_attn"], xn, kv.k[i],
                                        kv.v[i], kv.length)
        h = x + o
        hn = rms_norm(h, p["cross_norm"], cfg.norm_eps)
        q = (hn @ p["cross_attn"]["wq"]).reshape(B, 1, cfg.n_heads, hd)
        co = attn.gqa_attend(q, cache.cross_k[i], cache.cross_v[i], None,
                             softmax_scale=hd ** -0.5)
        h = h + co.reshape(B, 1, -1) @ p["cross_attn"]["wo"]
        x = h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"],
                                                  cfg.norm_eps))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h)
    return logits, cache._replace(self_kv=kv._replace(length=kv.length + 1))

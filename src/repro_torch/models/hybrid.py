"""Zamba2-style hybrid: Mamba2 backbone + one shared attention block.

The shared attention+MLP block (a single parameter set) is applied every
``attn_every`` layers.  The reference's layer scan is
:func:`repro_torch.core.psg.scan` with each block checkpointed under
``cfg.remat``; its ``lax.cond`` is a Python ``if`` in the body.  Training
attention is ``attention_train`` (the flash kernel under
``cfg.use_kernels``); prefill's is ``attend`` (einsum or chunked), as in
the reference.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import scan
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
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


def n_attn_sites(cfg: ArchConfig) -> int:
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def hybrid_specs(cfg: ArchConfig) -> Specs:
    mamba_layer = {
        "norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "ssd": mamba2.ssd_block_specs(cfg),
    }
    shared = {
        "attn_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "attn": attn.attention_specs(cfg),
        "mlp_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": mlp_specs(cfg),
    }
    return {
        "embed": embed_specs(cfg),
        "layers": stack_specs(mamba_layer, cfg.n_layers),
        "shared": shared,
        "final_norm": P((cfg.d_model,), ("embed",), init="zeros"),
    }


def _shared_block_train(cfg: ArchConfig, p: Dict[str, Any],
                        x: torch.Tensor) -> torch.Tensor:
    h = x + attn.attention_train(cfg, p["attn"],
                                 rms_norm(x, p["attn_norm"], cfg.norm_eps))
    return h + mlp_apply(cfg, p["mlp"],
                         rms_norm(h, p["mlp_norm"], cfg.norm_eps))


def backbone_train(cfg: ArchConfig, params: Dict[str, Any],
                   x: torch.Tensor) -> torch.Tensor:
    """All layers over embedded input x: (B, S, D); final-normed."""
    def body(x, xs):
        p, idx = xs
        if idx % cfg.attn_every == 0:
            x = _shared_block_train(cfg, params["shared"], x)
        return x + mamba2.ssd_block_train(
            cfg, p["ssd"], rms_norm(x, p["norm"], cfg.norm_eps)), None

    layers = unbind_layers(params["layers"], cfg.n_layers)
    x, _ = scan(body, x, list(zip(layers, range(cfg.n_layers))),
                name="layers", remat=cfg.remat)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over ``batch["tokens"]`` (B, S + 1);
    labels below 0 are masked out.  Returns (loss, metrics)."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    x = embed_tokens(params["embed"], inputs)
    h = backbone_train(cfg, params, x)
    mask = (labels >= 0).float()
    loss_sum, count = chunked_cross_entropy(
        params["embed"], h, torch.clamp(labels, min=0), mask, cfg.loss_chunk)
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"ce_loss": loss, "loss": loss, "tokens": count}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class HybridCache(NamedTuple):
    ssm: mamba2.SSMState          # stacked (L, ...)
    k: torch.Tensor               # (sites, B, S_max, n_kv, h)
    v: torch.Tensor
    length: torch.Tensor          # (B,) int32


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> HybridCache:
    kv_shape = (n_attn_sites(cfg), batch, max_len, cfg.n_kv_heads,
                cfg.resolved_head_dim())
    return HybridCache(
        mamba2.init_ssm_state(cfg, batch, cfg.n_layers, dtype, device),
        torch.zeros(kv_shape, dtype=dtype, device=device),
        torch.zeros(kv_shape, dtype=dtype, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _shared_block_decode(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor,
                         k_site: torch.Tensor, v_site: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """The shared block on one token; writes the site's new K/V into
    ``k_site`` and ``v_site`` in place."""
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    o, _, _ = attn.attention_decode(cfg, p["attn"], xn, k_site, v_site,
                                    lengths)
    h = x + o
    return h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"],
                                                 cfg.norm_eps))


def decode_step(cfg: ArchConfig, params: Dict[str, Any], cache: HybridCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, HybridCache]:
    """One decode step. tokens: (B, 1) int; returns (logits (B, 1, V),
    the advanced cache).  Each site's new K/V is written into the cache's
    K/V buffers in place (one slot a row, ``attention_decode``); the SSM
    states are new tensors, stacked afresh, so the caller's states are
    left as they are."""
    shared = params["shared"]
    x = embed_tokens(params["embed"], tokens)
    convs, hs = [], []
    for idx in range(cfg.n_layers):
        p = layer_params(params["layers"], idx)
        if idx % cfg.attn_every == 0:
            site = idx // cfg.attn_every
            x = _shared_block_decode(cfg, shared, x, cache.k[site],
                                     cache.v[site], cache.length)
        y, (conv_s, h) = mamba2.ssd_block_decode(
            cfg, p["ssd"], rms_norm(x, p["norm"], cfg.norm_eps),
            (cache.ssm.conv[idx], cache.ssm.h[idx]))
        x = x + y
        convs.append(conv_s)
        hs.append(h)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h)
    return logits, cache._replace(
        ssm=mamba2.SSMState(torch.stack(convs), torch.stack(hs)),
        length=cache.length + 1)


def prefill(cfg: ArchConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], max_len: int
            ) -> Tuple[torch.Tensor, HybridCache]:
    """Chunked prefill: SSD chunk scan per layer + shared-attn KV capture
    into K/V buffers of ``max_len`` positions that this function allocates
    and fills in place, site by site (zeros after position S)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    shared = params["shared"]
    hd = cfg.resolved_head_dim()
    kbuf = torch.zeros((n_attn_sites(cfg), B, max_len, cfg.n_kv_heads, hd),
                       dtype=x.dtype, device=x.device)
    vbuf = torch.zeros_like(kbuf)
    positions = torch.arange(S, device=x.device)[None, :]
    convs, hs = [], []
    for idx in range(cfg.n_layers):
        p = layer_params(params["layers"], idx)
        if idx % cfg.attn_every == 0:
            site = idx // cfg.attn_every
            xn = rms_norm(x, shared["attn_norm"], cfg.norm_eps)
            q, k, v = attn.qkv(cfg, shared["attn"], xn, positions)
            o = attn.attend(q, k, v, causal=True, softmax_scale=hd ** -0.5)
            x = x + o.reshape(B, S, -1) @ shared["attn"]["wo"]
            x = x + mlp_apply(cfg, shared["mlp"],
                              rms_norm(x, shared["mlp_norm"], cfg.norm_eps))
            kbuf[site, :, :S] = k
            vbuf[site, :, :S] = v
        y, (conv_s, h) = mamba2.ssd_block_train(
            cfg, p["ssd"], rms_norm(x, p["norm"], cfg.norm_eps),
            return_state=True)
        x = x + y
        convs.append(conv_s)
        hs.append(h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], x[:, -1:, :])
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    cache = HybridCache(mamba2.SSMState(torch.stack(convs), torch.stack(hs)),
                        kbuf, vbuf, lengths)
    return logits, cache

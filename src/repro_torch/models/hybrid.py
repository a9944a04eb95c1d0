"""Zamba2-style hybrid: Mamba2 backbone + one shared attention block.

The shared attention+MLP block (a single parameter set) is applied every
``attn_every`` layers.  The reference's layer scan is
:func:`repro_torch.core.psg.scan` with each block checkpointed under
``cfg.remat``; its ``lax.cond`` is :func:`repro_torch.core.psg.cond`, so
the PSG nests a Branch vertex in the layer Loop, as the reference's does:
exactly the control structure the paper's backtracking walks through.  Training
attention is ``attention_train`` (the flash kernel under
``cfg.use_kernels``); prefill's is ``attend`` (einsum or chunked), as in
the reference.  Under a ``model`` axis the SSD layers run on the rank's
heads (:mod:`repro_torch.models.mamba2`) and the shared block on its
attention heads and MLP columns, whose collectives sit inside the
Branch's arm; the embedding and the loss are vocab-parallel.  Under
sequence parallelism the residual stream and the norms are the rank's seq
slice, the SSD and shared blocks gathering it at their entry and
reduce-scattering their output.  Under ``gather_weights`` a Mamba
layer's leaves are gathered on ``data`` at the entry of the loop body,
the shared block's at each site's entry, the others at the entry of the
model function.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import cond, scan
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
from repro_torch.distributed import axes as ax
from repro_torch.models.params import P, Specs, gather_at_use
from repro_torch.models.transformer import (layer_params, stack_specs,
                                           unbind_layers)


def n_attn_sites(cfg: ArchConfig) -> int:
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def mamba_layer_specs(cfg: ArchConfig) -> Specs:
    return {
        "norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "ssd": mamba2.ssd_block_specs(cfg),
    }


def shared_specs(cfg: ArchConfig) -> Specs:
    return {
        "attn_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "attn": attn.attention_specs(cfg),
        "mlp_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "mlp": mlp_specs(cfg),
    }


def hybrid_specs(cfg: ArchConfig) -> Specs:
    return {
        "embed": embed_specs(cfg),
        "layers": stack_specs(mamba_layer_specs(cfg), cfg.n_layers),
        "shared": shared_specs(cfg),
        "final_norm": P((cfg.d_model,), ("embed",), init="zeros"),
    }


_SKIP = ("layers", "shared")      # gathered a layer, and a site, at a time


def _shared_block_train(cfg: ArchConfig, p: Dict[str, Any],
                        x: torch.Tensor, sp: bool = False) -> torch.Tensor:
    p = gather_at_use(p, shared_specs, cfg)
    eps = cfg.norm_eps
    h = x + attn.attention_train(cfg, p["attn"],
                                 rms_norm(x, p["attn_norm"], eps, sp), sp=sp)
    return h + mlp_apply(cfg, p["mlp"], rms_norm(h, p["mlp_norm"], eps, sp),
                         sp)


def backbone_train(cfg: ArchConfig, params: Dict[str, Any],
                   x: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """All layers over embedded input x: (B, S, D) (``sp``: the rank's
    seq slice); final-normed."""
    def body(x, xs):
        p, idx = xs
        p = gather_at_use(p, mamba_layer_specs, cfg)
        x = cond(idx % cfg.attn_every == 0,
                 lambda v: _shared_block_train(cfg, params["shared"], v, sp),
                 lambda v: v, x, name="shared")
        return x + mamba2.ssd_block_train(
            cfg, p["ssd"], rms_norm(x, p["norm"], cfg.norm_eps, sp),
            seq=sp), None

    layers = unbind_layers(params["layers"], cfg.n_layers)
    x, _ = scan(body, x, list(zip(layers, range(cfg.n_layers))),
                name="layers", remat=cfg.remat)
    return rms_norm(x, params["final_norm"], cfg.norm_eps, sp)


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over ``batch["tokens"]`` (B, S + 1);
    labels below 0 are masked out.  Returns (loss, metrics)."""
    params = gather_at_use(params, hybrid_specs, cfg, skip=_SKIP)
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    sp = ax.seq_parallel(inputs.shape[1])
    x = embed_tokens(params["embed"], inputs, cfg, sp)
    h = backbone_train(cfg, params, x, sp)
    mask = (labels >= 0).float()
    loss_sum, count = chunked_cross_entropy(
        params["embed"], h, torch.clamp(labels, min=0), mask, cfg.loss_chunk,
        cfg, sp)
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"ce_loss": loss, "loss": loss, "tokens": count}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class HybridCache(NamedTuple):
    ssm: mamba2.SSMState          # stacked (L, ...)
    k: torch.Tensor               # (sites, B, S_max, n_kv, h): the rank's
    v: torch.Tensor
    length: torch.Tensor          # (B,) int32


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> HybridCache:
    kv_shape = (n_attn_sites(cfg), batch, attn.cache_len(max_len),
                attn.heads(cfg).nkv, cfg.resolved_head_dim())
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
    p = gather_at_use(p, shared_specs, cfg)
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
    params = gather_at_use(params, hybrid_specs, cfg, skip=_SKIP)
    shared = params["shared"]
    x = embed_tokens(params["embed"], tokens, cfg)
    convs, hs = [], []
    for idx in range(cfg.n_layers):
        p = gather_at_use(layer_params(params["layers"], idx),
                          mamba_layer_specs, cfg)
        site = idx // cfg.attn_every
        x = cond(idx % cfg.attn_every == 0,
                 lambda v: _shared_block_decode(cfg, shared, v, cache.k[site],
                                                cache.v[site], cache.length),
                 lambda v: v, x, name="shared")
        y, (conv_s, h) = mamba2.ssd_block_decode(
            cfg, p["ssd"], rms_norm(x, p["norm"], cfg.norm_eps),
            (cache.ssm.conv[idx], cache.ssm.h[idx]))
        x = x + y
        convs.append(conv_s)
        hs.append(h)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h, cfg)
    return logits, cache._replace(
        ssm=mamba2.SSMState(torch.stack(convs), torch.stack(hs)),
        length=cache.length + 1)


def prefill(cfg: ArchConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], max_len: int
            ) -> Tuple[torch.Tensor, HybridCache]:
    """Chunked prefill: SSD chunk scan per layer + shared-attn KV capture
    into K/V buffers of ``max_len`` positions (the rank's slice where the
    rules split them) that this function allocates and fills in place,
    site by site (zeros after position S)."""
    params = gather_at_use(params, hybrid_specs, cfg, skip=_SKIP)
    tokens = batch["tokens"]
    B, S = tokens.shape
    sp = ax.seq_parallel(S)
    x = embed_tokens(params["embed"], tokens, cfg, sp)
    hd = cfg.resolved_head_dim()
    kbuf = torch.zeros((n_attn_sites(cfg), B, attn.cache_len(max_len),
                        attn.heads(cfg).nkv, hd), dtype=x.dtype,
                       device=x.device)
    vbuf = torch.zeros_like(kbuf)
    convs, hs = [], []
    def shared_block(x, site):
        shared = gather_at_use(params["shared"], shared_specs, cfg)
        xn = rms_norm(x, shared["attn_norm"], cfg.norm_eps, sp)
        q, k, v = attn.qkv(cfg, shared["attn"], xn, None, sp)
        o = attn.attend(q, *attn.kv_for_heads(cfg, k, v), causal=True,
                        softmax_scale=hd ** -0.5)
        x = x + attn.out_proj(cfg, shared["attn"], o, sp)
        x = x + mlp_apply(cfg, shared["mlp"],
                          rms_norm(x, shared["mlp_norm"], cfg.norm_eps, sp),
                          sp)
        kbuf[site] = attn.cache_positions(k, max_len)
        vbuf[site] = attn.cache_positions(v, max_len)
        return x

    for idx in range(cfg.n_layers):
        p = gather_at_use(layer_params(params["layers"], idx),
                          mamba_layer_specs, cfg)
        site = idx // cfg.attn_every
        x = cond(idx % cfg.attn_every == 0,
                 lambda v: shared_block(v, site), lambda v: v, x,
                 name="shared")
        y, (conv_s, h) = mamba2.ssd_block_train(
            cfg, p["ssd"], rms_norm(x, p["norm"], cfg.norm_eps, sp),
            return_state=True, seq=sp)
        x = x + y
        convs.append(conv_s)
        hs.append(h)
    x = ax.whole_seq(rms_norm(x, params["final_norm"], cfg.norm_eps, sp), sp)
    logits = logits_for(params["embed"], x[:, -1:, :], cfg)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    cache = HybridCache(mamba2.SSMState(torch.stack(convs), torch.stack(hs)),
                        kbuf, vbuf, lengths)
    return logits, cache

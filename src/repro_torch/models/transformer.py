"""Decoder-only transformer LM (dense / MoE / VLM backbones).

Per-layer parameters keep the JAX package's stacked layout (every block
leaf carries a leading ``n_layers`` axis).  The training layer loop is
:func:`repro_torch.core.psg.scan` over the layers' views of them, with
each block checkpointed under ``cfg.remat`` as the reference's
``jax.checkpoint``; serving loops over the layers in Python.  The VLM
family's vision tower is a stub: ``batch["patches"]`` (B, Np, D) of
precomputed patch embeddings, projected by ``patch_proj`` and prepended
to the token stream; its loss is over the text positions only.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import scan
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
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


def stack_specs(specs: Specs, n: int) -> Specs:
    """Add a leading stacked-layer dim to every leaf."""
    out: Specs = {}
    for k, v in specs.items():
        if isinstance(v, P):
            out[k] = P((n,) + v.shape, ("layers",) + v.axes, v.init, v.scale)
        else:
            out[k] = stack_specs(v, n)
    return out


def block_specs(cfg: ArchConfig) -> Specs:
    specs: Specs = {
        "attn_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "attn": attn.attention_specs(cfg),
        "mlp_norm": P((cfg.d_model,), ("embed",), init="zeros"),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_lib.moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg)
    return specs


def lm_specs(cfg: ArchConfig) -> Specs:
    return {
        "embed": embed_specs(cfg),
        "layers": stack_specs(block_specs(cfg), cfg.n_layers),
        "final_norm": P((cfg.d_model,), ("embed",), init="zeros"),
        **({"patch_proj": P((cfg.d_model, cfg.d_model), ("embed", "embed"))}
           if cfg.family == "vlm" else {}),
    }


def layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameters: views of the stacked leaves."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def unbind_layers(layers: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Every layer's parameters at once: one ``unbind`` of each stacked
    leaf, whose gradient is one ``stack`` (not a scatter per layer)."""
    cols = {k: unbind_layers(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in layers.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def _block_train(cfg: ArchConfig, moe_strategy: str, x: torch.Tensor,
                 p: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block. Returns (x, moe_aux): the (aux, z, drop) 3-vector of the
    MoE layer, or zeros."""
    h = x + attn.attention_train(cfg, p["attn"],
                                 rms_norm(x, p["attn_norm"], cfg.norm_eps))
    hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    if cfg.family == "moe":
        y, m = moe_lib.moe_apply(cfg, p["moe"], hn, moe_strategy)
        aux = torch.stack([m["moe_aux_loss"], m["moe_z_loss"],
                           m["moe_drop_frac"]])
    else:
        y = mlp_apply(cfg, p["mlp"], hn)
        aux = torch.zeros((3,), dtype=torch.float32, device=x.device)
    return h + y, aux


def backbone_train(cfg: ArchConfig, params: Dict[str, Any], x: torch.Tensor,
                   moe_strategy: str = "einsum"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all blocks over embedded input x: (B, S, D).  Returns the
    final-normed h and the layers' MoE 3-vectors summed."""
    x, auxs = scan(lambda h, p: _block_train(cfg, moe_strategy, h, p), x,
                   unbind_layers(params["layers"], cfg.n_layers),
                   name="layers", remat=cfg.remat)
    return (rms_norm(x, params["final_norm"], cfg.norm_eps),
            torch.sum(torch.stack(auxs), dim=0))


def _embed_inputs(cfg: ArchConfig, params: Dict[str, Any],
                  batch: Dict[str, torch.Tensor],
                  tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings, with the VLM family's projected patches
    prepended."""
    x = embed_tokens(params["embed"], tokens)
    if cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
    return x


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor], moe_strategy: str = "einsum"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over ``batch["tokens"]`` (B, S + 1);
    labels below 0 are masked out.  The MoE family adds ``0.01·aux +
    1e-3·z``; the VLM family prepends ``batch["patches"]`` and scores the
    text positions only.  Returns (loss, metrics)."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    x = _embed_inputs(cfg, params, batch, inputs)
    h, aux = backbone_train(cfg, params, x, moe_strategy)
    if cfg.family == "vlm":                   # loss over text positions only
        h = h[:, batch["patches"].shape[1]:]
    mask = (labels >= 0).float()
    loss_sum, count = chunked_cross_entropy(
        params["embed"], h, torch.clamp(labels, min=0), mask, cfg.loss_chunk)
    loss = loss_sum / torch.clamp(count, min=1.0)
    metrics = {"ce_loss": loss, "tokens": count}
    if cfg.family == "moe":
        metrics.update(moe_aux_loss=aux[0], moe_z_loss=aux[1],
                       moe_drop_frac=aux[2])
        loss = loss + 0.01 * aux[0] + 1e-3 * aux[1]
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class LMCache(NamedTuple):
    kv: attn.KVCache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> LMCache:
    return LMCache(attn.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                      dtype, device))


def _serve_ffn(cfg: ArchConfig, p: Dict[str, Any],
               hn: torch.Tensor) -> torch.Tensor:
    """The block's FFN at serve time: the MoE layer at
    ``SERVE_CAPACITY_FACTOR`` (einsum dispatch), or the MLP."""
    if cfg.family == "moe":
        return moe_lib.moe_apply(
            cfg, p["moe"], hn,
            capacity_factor=moe_lib.SERVE_CAPACITY_FACTOR)[0]
    return mlp_apply(cfg, p["mlp"], hn)


def _block_prefill(cfg: ArchConfig, x: torch.Tensor, p: Dict[str, Any],
                   max_len: int):
    """Block forward that also emits this layer's (padded) K/V for the
    cache.  Attention is the einsum path, as in the JAX package."""
    B, S, _ = x.shape
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = attn.qkv(cfg, p["attn"], xn, positions)
    o = attn.attend(q, k, v, causal=True,
                    softmax_scale=cfg.resolved_head_dim() ** -0.5)
    h = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
    out = h + _serve_ffn(cfg, p, rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    pad = (0, 0, 0, 0, 0, max_len - S)          # zeros after position S
    return out, (F.pad(k, pad), F.pad(v, pad))


def prefill(cfg: ArchConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], max_len: int
            ) -> Tuple[torch.Tensor, LMCache]:
    """Process the full prompt (for the VLM family, the patches and then
    the tokens); returns (last-position logits, primed cache of
    ``max_len`` positions)."""
    x = _embed_inputs(cfg, params, batch, batch["tokens"])
    B, S, _ = x.shape
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block_prefill(cfg, x, layer_params(params["layers"], i),
                                   max_len)
        ks.append(k)
        vs.append(v)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h[:, -1:, :])
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, LMCache(attn.KVCache(torch.stack(ks), torch.stack(vs),
                                        lengths))


def decode_step(cfg: ArchConfig, params: Dict[str, Any], cache: LMCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, LMCache]:
    """One decode step. tokens: (B, 1) int; returns (logits (B, 1, V),
    the cache one token longer).  Each layer's new K/V is written into the
    cache's buffers in place (``attention_decode``)."""
    kv = cache.kv
    x = embed_tokens(params["embed"], tokens)
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        o, _, _ = attn.attention_decode(cfg, p["attn"], xn, kv.k[i],
                                        kv.v[i], kv.length)
        h = x + o
        x = h + _serve_ffn(cfg, p, rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h)
    return logits, LMCache(kv._replace(length=kv.length + 1))

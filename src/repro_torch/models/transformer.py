"""Decoder-only transformer LM (dense / MoE / VLM backbones).

Per-layer parameters keep the JAX package's stacked layout (every block
leaf carries a leading ``n_layers`` axis).  The training layer loop is
:func:`repro_torch.core.psg.scan` over the layers' views of them, with
each block checkpointed under ``cfg.remat`` as the reference's
``jax.checkpoint``; serving loops over the layers in Python.  The VLM
family's vision tower is a stub: ``batch["patches"]`` (B, Np, D) of
precomputed patch embeddings, projected by ``patch_proj`` and prepended
to the token stream; its loss is over the text positions only.

Under a ``model`` axis every block runs on the rank's shards (attention
heads, MLP columns, experts; :mod:`repro_torch.models.attention`,
:mod:`~repro_torch.models.layers`, :mod:`~repro_torch.models.moe`), the
embedding and the loss are vocab-parallel, and the residual stream, the
norms and the VLM's patch projection are whole on every rank, or, under
sequence parallelism (``seq_shard``: the rules put ``res_seq`` on
``model`` and the sequence divides it), the residual stream and the norms
are the rank's seq slice (the VLM's embedded patches and tokens are cut
to it).  Under ``gather_weights`` a layer's leaves are gathered on
``data`` at the entry of its loop body, the others at the entry of the
model function (:func:`repro_torch.models.params.gather_at_use`).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

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
from repro_torch.distributed import axes as ax
from repro_torch.models.params import P, Specs, gather_at_use


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

def _block_train(cfg: ArchConfig, moe_strategy: str, sp: bool,
                 x: torch.Tensor, p: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block (``sp``: x is the rank's seq slice). Returns (x,
    moe_aux): the (aux, z, drop) 3-vector of the MoE layer, or zeros."""
    p = gather_at_use(p, block_specs, cfg)
    eps = cfg.norm_eps
    h = x + attn.attention_train(cfg, p["attn"],
                                 rms_norm(x, p["attn_norm"], eps, sp), sp=sp)
    hn = rms_norm(h, p["mlp_norm"], eps, sp)
    if cfg.family == "moe":
        y, m = moe_lib.moe_apply(cfg, p["moe"], hn, moe_strategy, sp=sp)
        aux = torch.stack([m["moe_aux_loss"], m["moe_z_loss"],
                           m["moe_drop_frac"]])
    else:
        y = mlp_apply(cfg, p["mlp"], hn, sp)
        aux = torch.zeros((3,), dtype=torch.float32, device=x.device)
    return h + y, aux


def backbone_train(cfg: ArchConfig, params: Dict[str, Any], x: torch.Tensor,
                   moe_strategy: str = "einsum", sp: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all blocks over embedded input x: (B, S, D) (``sp``: the rank's
    seq slice).  Returns the final-normed h and the layers' MoE 3-vectors
    summed."""
    x, auxs = scan(lambda h, p: _block_train(cfg, moe_strategy, sp, h, p),
                   x, unbind_layers(params["layers"], cfg.n_layers),
                   name="layers", remat=cfg.remat)
    return (rms_norm(x, params["final_norm"], cfg.norm_eps, sp),
            torch.sum(torch.stack(auxs), dim=0))


def _seq_len(cfg: ArchConfig, batch: Dict[str, torch.Tensor],
             tokens: torch.Tensor) -> int:
    """The residual stream's length: the tokens, after the VLM's patches."""
    extra = batch["patches"].shape[1] if cfg.family == "vlm" else 0
    return extra + tokens.shape[1]


def _embed_inputs(cfg: ArchConfig, params: Dict[str, Any],
                  batch: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """The token embeddings, with the VLM family's projected patches
    prepended (``sp``: the rank's seq slice)."""
    if cfg.family != "vlm":
        return embed_tokens(params["embed"], tokens, cfg, sp)
    x = embed_tokens(params["embed"], tokens, cfg)
    patches = batch["patches"].to(x.dtype) @ params["patch_proj"]
    return ax.own_seq(torch.cat([patches, x], dim=1), sp)


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor], moe_strategy: str = "einsum"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over ``batch["tokens"]`` (B, S + 1);
    labels below 0 are masked out.  The MoE family adds ``0.01·aux +
    1e-3·z``; the VLM family prepends ``batch["patches"]`` and scores the
    text positions only.  Returns (loss, metrics)."""
    params = gather_at_use(params, lm_specs, cfg, skip=("layers",))
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    sp = ax.seq_parallel(_seq_len(cfg, batch, inputs))
    x = _embed_inputs(cfg, params, batch, inputs, sp)
    h, aux = backbone_train(cfg, params, x, moe_strategy, sp)
    if cfg.family == "vlm":                   # loss over text positions only
        h = ax.whole_seq(h, sp)[:, batch["patches"].shape[1]:]
        sp = False
    mask = (labels >= 0).float()
    loss_sum, count = chunked_cross_entropy(
        params["embed"], h, torch.clamp(labels, min=0), mask, cfg.loss_chunk,
        cfg, sp)
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
               hn: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """The block's FFN at serve time: the MoE layer at
    ``SERVE_CAPACITY_FACTOR`` (einsum dispatch), or the MLP."""
    if cfg.family == "moe":
        return moe_lib.moe_apply(
            cfg, p["moe"], hn,
            capacity_factor=moe_lib.SERVE_CAPACITY_FACTOR, sp=sp)[0]
    return mlp_apply(cfg, p["mlp"], hn, sp)


def _block_prefill(cfg: ArchConfig, x: torch.Tensor, p: Dict[str, Any],
                   max_len: int, sp: bool = False):
    """Block forward that also emits this layer's K/V for the cache
    (zeros after the prompt; the rank's positions where the rules split
    them).  Attention is the einsum path, as in the JAX package."""
    p = gather_at_use(p, block_specs, cfg)
    xn = rms_norm(x, p["attn_norm"], cfg.norm_eps, sp)
    q, k, v = attn.qkv(cfg, p["attn"], xn, None, sp)
    o = attn.attend(q, *attn.kv_for_heads(cfg, k, v), causal=True,
                    softmax_scale=cfg.resolved_head_dim() ** -0.5)
    h = x + attn.out_proj(cfg, p["attn"], o, sp)
    out = h + _serve_ffn(cfg, p, rms_norm(h, p["mlp_norm"], cfg.norm_eps, sp),
                         sp)
    return out, (attn.cache_positions(k, max_len),
                 attn.cache_positions(v, max_len))


def prefill(cfg: ArchConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], max_len: int
            ) -> Tuple[torch.Tensor, LMCache]:
    """Process the full prompt (for the VLM family, the patches and then
    the tokens); returns (last-position logits, primed cache of
    ``max_len`` positions)."""
    params = gather_at_use(params, lm_specs, cfg, skip=("layers",))
    B, S = batch["tokens"].shape[0], _seq_len(cfg, batch, batch["tokens"])
    sp = ax.seq_parallel(S)
    x = _embed_inputs(cfg, params, batch, batch["tokens"], sp)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block_prefill(cfg, x, layer_params(params["layers"], i),
                                   max_len, sp)
        ks.append(k)
        vs.append(v)
    h = ax.whole_seq(rms_norm(x, params["final_norm"], cfg.norm_eps, sp), sp)
    logits = logits_for(params["embed"], h[:, -1:, :], cfg)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, LMCache(attn.KVCache(torch.stack(ks), torch.stack(vs),
                                        lengths))


def decode_step(cfg: ArchConfig, params: Dict[str, Any], cache: LMCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, LMCache]:
    """One decode step. tokens: (B, 1) int; returns (logits (B, 1, V),
    the cache one token longer).  Each layer's new K/V is written into the
    cache's buffers in place (``attention_decode``)."""
    params = gather_at_use(params, lm_specs, cfg, skip=("layers",))
    kv = cache.kv
    x = embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        p = gather_at_use(layer_params(params["layers"], i), block_specs, cfg)
        xn = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        o, _, _ = attn.attention_decode(cfg, p["attn"], xn, kv.k[i],
                                        kv.v[i], kv.length)
        h = x + o
        x = h + _serve_ffn(cfg, p, rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h, cfg)
    return logits, LMCache(kv._replace(length=kv.length + 1))

"""Pure-SSM language model (mamba2-130m family): attention-free.

Per-layer parameters keep the JAX package's stacked layout; the
reference's ``jax.lax.scan`` over layers is
:func:`repro_torch.core.psg.scan` over per-layer views, with each block
checkpointed under ``cfg.remat`` (except where the states are
collected, as in the reference).  Under a ``model`` axis the SSD blocks
run on the rank's heads (:mod:`repro_torch.models.mamba2`), the tied
embedding and the loss are vocab-parallel, and the residual stream and
the norms are whole on every rank, or under sequence parallelism the
rank's seq slice (:mod:`repro_torch.models.transformer` says how).  Under
``gather_weights`` a layer's leaves are gathered on ``data`` at the entry
of its loop body, the others at the entry of the model function.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.psg import scan
from repro_torch.models import mamba2
from repro_torch.models.layers import (
    chunked_cross_entropy,
    embed_specs,
    embed_tokens,
    logits_for,
    rms_norm,
)
from repro_torch.distributed import axes as ax
from repro_torch.models.params import P, Specs, gather_at_use
from repro_torch.models.transformer import (layer_params, stack_specs,
                                           unbind_layers)


def layer_specs(cfg: ArchConfig) -> Specs:
    return {
        "norm": P((cfg.d_model,), ("embed",), init="zeros"),
        "ssd": mamba2.ssd_block_specs(cfg),
    }


def ssm_lm_specs(cfg: ArchConfig) -> Specs:
    return {
        "embed": embed_specs(cfg),
        "layers": stack_specs(layer_specs(cfg), cfg.n_layers),
        "final_norm": P((cfg.d_model,), ("embed",), init="zeros"),
    }


def _backbone(cfg: ArchConfig, params: Dict[str, Any], x: torch.Tensor,
              collect_state: bool, sp: bool = False):
    """All layers over x: (B, S, D) (``sp``: the rank's seq slice);
    final-normed.  With ``collect_state`` also the per-layer (conv, h)
    states stacked into the reference's (L, ...) layout, else None."""
    def body(x, p):
        p = gather_at_use(p, layer_specs, cfg)
        y, st = mamba2.ssd_block_train(
            cfg, p["ssd"], rms_norm(x, p["norm"], cfg.norm_eps, sp),
            return_state=True, seq=sp)
        return x + y, st if collect_state else None

    x, sts = scan(body, x, unbind_layers(params["layers"], cfg.n_layers),
                  name="layers", remat=cfg.remat and not collect_state)
    states = (torch.stack([c for c, _ in sts]),
              torch.stack([h for _, h in sts])) if collect_state else None
    return rms_norm(x, params["final_norm"], cfg.norm_eps, sp), states


def train_loss(cfg: ArchConfig, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over ``batch["tokens"]`` (B, S + 1);
    labels below 0 are masked out.  Returns (loss, metrics)."""
    params = gather_at_use(params, ssm_lm_specs, cfg, skip=("layers",))
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    sp = ax.seq_parallel(inputs.shape[1])
    x = embed_tokens(params["embed"], inputs, cfg, sp)
    h, _ = _backbone(cfg, params, x, collect_state=False, sp=sp)
    mask = (labels >= 0).float()
    loss_sum, count = chunked_cross_entropy(
        params["embed"], h, torch.clamp(labels, min=0), mask, cfg.loss_chunk,
        cfg, sp)
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"ce_loss": loss, "loss": loss, "tokens": count}


class SSMCache(NamedTuple):
    ssm: mamba2.SSMState       # stacked (L, ...)
    length: torch.Tensor       # (B,) int32


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> SSMCache:
    del max_len                # state is O(1) in history length
    return SSMCache(mamba2.init_ssm_state(cfg, batch, cfg.n_layers, dtype,
                                          device),
                    torch.zeros((batch,), dtype=torch.int32, device=device))


def prefill(cfg: ArchConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], max_len: int
            ) -> Tuple[torch.Tensor, SSMCache]:
    """Process the full prompt; returns (last-position logits, the
    per-layer states)."""
    params = gather_at_use(params, ssm_lm_specs, cfg, skip=("layers",))
    tokens = batch["tokens"]
    B, S = tokens.shape
    sp = ax.seq_parallel(S)
    x = embed_tokens(params["embed"], tokens, cfg, sp)
    h, (conv_s, ssm_h) = _backbone(cfg, params, x, collect_state=True, sp=sp)
    h = ax.whole_seq(h, sp)
    logits = logits_for(params["embed"], h[:, -1:, :], cfg)
    cache = SSMCache(mamba2.SSMState(conv_s, ssm_h),
                     torch.full((B,), S, dtype=torch.int32,
                                device=x.device))
    return logits, cache


def decode_step(cfg: ArchConfig, params: Dict[str, Any], cache: SSMCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, SSMCache]:
    """One decode step. tokens: (B, 1) int; returns (logits (B, 1, V),
    the advanced states)."""
    params = gather_at_use(params, ssm_lm_specs, cfg, skip=("layers",))
    x = embed_tokens(params["embed"], tokens, cfg)
    convs, hs = [], []
    for i in range(cfg.n_layers):
        p = gather_at_use(layer_params(params["layers"], i), layer_specs, cfg)
        y, (conv_s, h) = mamba2.ssd_block_decode(
            cfg, p["ssd"], rms_norm(x, p["norm"], cfg.norm_eps),
            (cache.ssm.conv[i], cache.ssm.h[i]))
        x = x + y
        convs.append(conv_s)
        hs.append(h)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_for(params["embed"], h, cfg)
    return logits, SSMCache(mamba2.SSMState(torch.stack(convs),
                                            torch.stack(hs)),
                            cache.length + 1)

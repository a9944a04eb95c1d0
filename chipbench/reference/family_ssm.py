"""Reference loss of an attention-free Mamba2 language model
(arXiv:2405.21060): embedding, L pre-norm residual SSD blocks, a final
RMS norm and the (tied or untied) LM head under a mean next-token
cross-entropy."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from chipbench.reference.layers import cross_entropy_sum, rms_norm, ssd_block


def head(params: dict) -> torch.Tensor:
    emb = params["embed"]
    return emb["unembed"] if "unembed" in emb else emb["embedding"].T


def layer(params: dict, i: int) -> dict:
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["layers"])


def mamba_layer(x: torch.Tensor, p: dict, arch) -> torch.Tensor:
    return x + ssd_block(p["ssd"], rms_norm(x, p["norm"], arch.norm_eps),
                         arch)


def loss(params: dict, tokens: torch.Tensor, arch, *,
         remat: bool = True) -> torch.Tensor:
    """Mean cross-entropy of tokens[:, 1:] given tokens[:, :-1]."""
    x = params["embed"]["embedding"][tokens[:, :-1]]
    for i in range(arch.n_layers):
        p = layer(params, i)
        x = (checkpoint(mamba_layer, x, p, arch, use_reentrant=False)
             if remat else mamba_layer(x, p, arch))
    h = rms_norm(x, params["final_norm"], arch.norm_eps)
    labels = tokens[:, 1:]
    return cross_entropy_sum(h, head(params), labels, arch.loss_rows,
                             remat) / labels.numel()

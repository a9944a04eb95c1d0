"""Reference loss of a Zamba2-style hybrid (arXiv:2411.15242): the Mamba2
backbone of ``family_ssm`` with one shared attention + MLP block (a
single parameter set) applied before every ``attn_every``-th Mamba layer,
starting with the first."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from chipbench.reference.family_ssm import head, layer, mamba_layer
from chipbench.reference.layers import (attention, cross_entropy_sum, mlp,
                                        rms_norm)


def shared_block(x: torch.Tensor, p: dict, arch) -> torch.Tensor:
    h = x + attention(p["attn"], rms_norm(x, p["attn_norm"], arch.norm_eps),
                      arch)
    return h + mlp(p["mlp"], rms_norm(h, p["mlp_norm"], arch.norm_eps), arch)


def loss(params: dict, tokens: torch.Tensor, arch, *,
         remat: bool = True) -> torch.Tensor:
    def run(fn, *args):
        return (checkpoint(fn, *args, use_reentrant=False) if remat
                else fn(*args))

    x = params["embed"]["embedding"][tokens[:, :-1]]
    for i in range(arch.n_layers):
        if i % arch.attn_every == 0:
            x = run(shared_block, x, params["shared"], arch)
        x = run(mamba_layer, x, layer(params, i), arch)
    h = rms_norm(x, params["final_norm"], arch.norm_eps)
    labels = tokens[:, 1:]
    return cross_entropy_sum(h, head(params), labels, arch.loss_rows,
                             remat) / labels.numel()

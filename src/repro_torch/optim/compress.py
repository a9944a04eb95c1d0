"""Gradient compression with error feedback.

int8 block quantization of (grad + residual) per 256-element block with
a per-block float32 scale; the quantization error is the next step's
residual (Karimireddy et al. style error feedback).  The JAX package's
formulas: codes are ``round(x / scale)`` with ties to even (as
``jnp.round``), clipped to [-127, 127].
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.tree import Tree, leaves, tree_map, unflatten_like

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def compress_leaf(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes [n/BLOCK, BLOCK], float32 scales [n/BLOCK])."""
    blocks = _pad_to_block(x.float()).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    safe = torch.clamp(scale, min=1e-30)
    codes = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127
                        ).to(torch.int8)
    return codes, scale


def decompress_leaf(codes: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (codes.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def compress_grads(grads: Tree) -> Tree:
    return tree_map(compress_leaf, grads)


def decompress_grads(comp: Tree, like: Tree) -> Tree:
    return tree_map(lambda c, g: decompress_leaf(c[0], c[1], g.shape,
                                                 g.dtype), comp, like)


def error_feedback_update(grads: Tree, residual: Tree) -> Tuple[Tree, Tree]:
    """(compressed-then-decompressed grads, new residual).

    new_residual = (grad + residual) - Q(grad + residual); the returned
    grads are Q(grad + residual): what the all-reduce actually averages.
    """
    def one(g, r):
        acc = g.float() + r
        codes, scale = compress_leaf(acc)
        deq = decompress_leaf(codes, scale, g.shape, torch.float32)
        return deq.to(g.dtype), acc - deq

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten_like(grads, [o[0] for o in outs]),
            unflatten_like(grads, [o[1] for o in outs]))


def init_residual(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)

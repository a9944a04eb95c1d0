"""The matrix-product work of one training step, counted from a
configuration's shapes: 2*m*n*k for each product of the forward pass,
times 3 for the forward and the two products of its backward.  Remat's
recompute is left out: the count is the configuration's work, the same
whatever implements it.

``needed`` (the default) counts the causal products at what causality
needs: attention's score and value products, and the SSD's products
inside a chunk, over the lower triangle with its diagonal.  With
``needed=False`` every product counts whole, as the plain reference
computes it (``chipbench/tests`` hold that count against
``torch.utils.flop_counter.FlopCounterMode`` over the reference).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple


def _tri(n: int, needed: bool) -> float:
    """Entries of an n x n causal product that are computed."""
    return n * (n + 1) / 2 if needed else n * n


def forward_products(arch: Dict, batch: int, seq: int,
                     needed: bool = True) -> List[Tuple[str, float]]:
    """(name, FLOPs) of each product kind of one forward pass over
    ``batch`` rows of ``seq`` positions (inputs, not the shifted labels)."""
    d, L, V = arch["d_model"], arch["n_layers"], arch["vocab_size"]
    T = batch * seq
    out: List[Tuple[str, float]] = []
    if arch["ssm_state"]:
        di = arch["ssm_expand"] * d
        P = arch["ssm_head_dim"]
        H, N = di // P, arch["ssm_state"]
        Q = min(arch["ssm_chunk"], seq)
        chunks = batch * math.ceil(seq / Q)
        Tp = chunks * Q                       # positions with the padding
        out += [
            ("ssd.in_proj", L * 2.0 * T * d * (2 * di + 2 * N + H)),
            ("ssd.chunk_CB", L * 2.0 * chunks * _tri(Q, needed) * N),
            ("ssd.chunk_y", L * 2.0 * chunks * _tri(Q, needed) * H * P),
            ("ssd.states", L * 2.0 * Tp * N * H * P),
            ("ssd.state_y", L * 2.0 * Tp * N * H * P),
            ("ssd.out_proj", L * 2.0 * T * di * d),
        ]
    if arch.get("attn_every"):
        sites = math.ceil(L / arch["attn_every"])
        nh, nkv = arch["n_heads"], arch["n_kv_heads"]
        hd = arch.get("head_dim") or d // nh
        out += [
            ("attn.qkvo", sites * 2.0 * T * d * (2 * nh + 2 * nkv) * hd),
            ("attn.scores", sites * 2.0 * batch * nh * _tri(seq, needed) * hd),
            ("attn.values", sites * 2.0 * batch * nh * _tri(seq, needed) * hd),
            ("mlp", sites * 2.0 * T * d * arch["d_ff"] * 2),
        ]
    out.append(("lm_head", 2.0 * T * d * V))
    return out


def train_step_flops(arch: Dict, batch: int, seq: int,
                     needed: bool = True) -> float:
    """Forward and backward matrix-product FLOPs of one step."""
    return 3.0 * sum(f for _, f in forward_products(arch, batch, seq, needed))

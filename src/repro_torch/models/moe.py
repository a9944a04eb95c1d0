"""Top-k Mixture-of-Experts FFN: the JAX package's ``models/moe.py`` on
torch.

Two dispatch strategies, as in the reference:

* ``einsum`` — dispatch/combine one-hot einsums (the default; the serving
  path's).
* ``sort``   — sort-by-expert gather/scatter dispatch.

Capacity-based token dropping, the switch load-balance loss and the router
z-loss are implemented for both.  The reference's sharding hints
(``logical_constraint``, ``weight_constraint``) are identities on one
card and are left out.  No kernel is hand-written here: the products are
``torch.einsum`` / ``torch.bmm``.

Ordering rules kept from the reference: ``jax.lax.top_k`` puts the lower
expert first among equal probabilities, so top-k is a stable descending
sort; ``jnp.argsort(stable=True)`` is ``torch.argsort(stable=True)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import P

CAPACITY_FACTOR = 1.25


def moe_specs(cfg: ArchConfig) -> Dict[str, P]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs = {
        "router": P((d, e), ("embed", "experts")),
        "w_up": P((e, d, f), ("experts", "embed", "mlp")),
        "w_down": P((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        specs["w_gate"] = P((e, d, f), ("experts", "embed", "mlp"))
    return specs


def _expert_ffn(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) -> (E, C, D), per-expert weights stacked on E: one
    batched product per weight over every expert."""
    if cfg.mlp == "swiglu":
        h = F.silu(torch.bmm(x, p["w_gate"])) * torch.bmm(x, p["w_up"])
    elif cfg.mlp == "geglu":
        h = F.gelu(torch.bmm(x, p["w_gate"]), approximate="tanh") \
            * torch.bmm(x, p["w_up"])
    else:
        h = F.gelu(torch.bmm(x, p["w_up"]), approximate="tanh")
    return torch.bmm(h, p["w_down"])


def _routing(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor):
    """Router probabilities and top-k selection.

    x: (T, D). Returns (weights (T,k), experts (T,k), aux_loss, z_loss).
    """
    logits = (x @ p["router"]).float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: largest first, the lower index first among ties
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # switch-style load-balance loss
    T, E = logits.shape
    me = torch.mean(probs, dim=0)                      # mean prob / expert
    ce = torch.mean(torch.sum(F.one_hot(top_e, E).float(), dim=1),
                    dim=0) / k                         # frac tokens / expert
    aux = E * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return top_w, top_e, aux, z


def _capacity(cfg: ArchConfig, n_tokens: int,
              capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Tokens-per-expert buffer size.

    Clamped to n_tokens (an expert can receive at most every token once), so
    small serve-time batches with a generous factor become exactly dropless.
    """
    cap = int(n_tokens * cfg.experts_per_token * capacity_factor
              // cfg.n_experts)
    return min(max(cap, 4), n_tokens)


def _group_tokens(cfg: ArchConfig,
                  x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(B,S,D) -> (B, G, gs, D): routing groups along the sequence (the
    dispatch one-hot is (gs, E, C) with C ∝ gs, quadratic in the group
    size)."""
    B, S, D = x.shape
    gs = cfg.moe_group_size or S
    gs = min(gs, S)
    while S % gs:
        gs -= 1
    return x.reshape(B, S // gs, gs, D), gs


def moe_apply_einsum(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor,
                     capacity_factor: float = CAPACITY_FACTOR
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Grouped dispatch/combine einsum formulation. x: (B,S,D)."""
    B, S, D = x.shape
    xg, gs = _group_tokens(cfg, x)                           # (B,G,gs,D)
    G = xg.shape[1]
    xf = xg.reshape(B * G * gs, D)
    top_w, top_e, aux, z = _routing(cfg, p, xf)
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(cfg, gs, capacity_factor)
    top_w = top_w.reshape(B, G, gs, k)
    top_e = top_e.reshape(B, G, gs, k)

    # position of each (token, slot) within its expert's per-group buffer
    onehot = F.one_hot(top_e, E)                             # (B,G,gs,k,E)
    flat = onehot.reshape(B, G, gs * k, E)
    pos = torch.cumsum(flat, dim=2) - flat                   # (B,G,gs*k,E)
    pos = torch.sum(pos * flat, dim=-1).reshape(B, G, gs, k)
    keep = pos < C
    w = top_w * keep.to(top_w.dtype)

    # dispatch (gs,E,C) one-hot and combine weights, per group.  A token's
    # k experts differ, so each (s, e, c) sums one nonzero term over k:
    # folding w into the one-hot first gives the reference's values
    pos_oh = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C]
    disp = torch.einsum("bgske,bgskc->bgsec", onehot.to(x.dtype),
                        pos_oh.to(x.dtype))                  # (B,G,gs,E,C)
    comb = torch.einsum("bgske,bgskc->bgsec",
                        onehot.float() * w.float()[..., None],
                        pos_oh.float()).to(x.dtype)

    xe = torch.einsum("bgsec,bgsd->bgecd", disp, xg)         # (B,G,E,C,D)
    ye = _expert_ffn_grouped(cfg, p, xe)
    y = torch.einsum("bgsec,bgecd->bgsd", comb, ye)
    y = y.reshape(B, S, D)
    keepf = torch.mean(keep.float())
    metrics = {"moe_aux_loss": aux, "moe_z_loss": z,
               "moe_drop_frac": 1.0 - keepf}
    return y, metrics


def _expert_ffn_grouped(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                        xe: torch.Tensor) -> torch.Tensor:
    """xe: (B,G,E,C,D) -> (B,G,E,C,D); expert weights stacked on E.  The
    groups' buffers go through :func:`_expert_ffn` as one (E, B·G·C, D)
    batch, so each expert's weights are read once, not once a group."""
    B, G, E, C, D = xe.shape
    x = xe.permute(2, 0, 1, 3, 4).reshape(E, B * G * C, D)
    y = _expert_ffn(cfg, p, x)
    return y.reshape(E, B, G, C, D).permute(1, 2, 0, 3, 4)


def moe_apply_sort(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                   x: torch.Tensor,
                   capacity_factor: float = CAPACITY_FACTOR
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Grouped sort-based gather/scatter dispatch (no dispatch matmul).

    The reference maps ``one_group`` over the B·G groups with
    ``jax.vmap``; here every group is one row of a batched pass, its
    buffers and tokens addressed with the group's offset.  At decode
    (gs = 1) that is one argsort of (B, k) and one product per expert
    weight over all B groups.

    The reference sends a dropped slot of expert e to buffer row
    (e + 1)·C, the next expert's first slot, where its in-order scatter
    lets the kept slot written after it win (the last expert's drops land
    in the overflow row E·C, which is cut off).  Here only kept slots are
    written.  That gives the reference's outputs: a row that only a
    dropped slot wrote is read back only with weight 0.
    """
    B, S, D = x.shape
    xg, gs = _group_tokens(cfg, x)                           # (B,G,gs,D)
    G = xg.shape[1]
    n = B * G
    xf = xg.reshape(n * gs, D)
    top_w, top_e, aux, z = _routing(cfg, p, xf)
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(cfg, gs, capacity_factor)
    dev = x.device

    flat_e = top_e.reshape(n, gs * k)
    order = torch.argsort(flat_e, dim=1, stable=True)        # slots by expert
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((n, E), dtype=torch.long, device=dev).scatter_add_(
        1, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, dim=1) - counts            # (n, E)
    pos_in_e = (torch.arange(gs * k, device=dev)[None, :]
                - torch.gather(starts, 1, sorted_e))
    keep = pos_in_e < C
    dest = sorted_e * C + torch.where(keep, pos_in_e, C)     # C -> overflow
    token_of_slot = order // k
    offset = torch.arange(n, device=dev)[:, None]
    rows = offset * (E * C + 1) + dest                       # group's buffer
    tokens = offset * gs + token_of_slot                     # group's tokens
    kept = keep.reshape(-1)
    buf = torch.zeros((n * (E * C + 1), D), dtype=x.dtype, device=dev)
    buf[rows.reshape(-1)[kept]] = xf[tokens.reshape(-1)[kept]]
    buf = buf.reshape(n, E * C + 1, D)
    xe = buf[:, :E * C].reshape(n, E, C, D)
    ye = _expert_ffn_grouped(cfg, p, xe[None]).reshape(n, E * C, D)
    ye = torch.cat([ye, torch.zeros((n, 1, D), dtype=ye.dtype, device=dev)],
                   dim=1).reshape(n * (E * C + 1), D)
    back = ye[rows.reshape(-1)]                              # (n·gs·k, D)
    w_sorted = (torch.gather(top_w.reshape(n, gs * k), 1, order)
                * keep.to(top_w.dtype)).reshape(-1)
    contrib = back * w_sorted[:, None].to(back.dtype)
    y = torch.zeros((n * gs, D), dtype=torch.float32, device=dev).index_add_(
        0, tokens.reshape(-1), contrib.float())
    keepf = torch.mean(keep.float(), dim=1)                  # per group
    metrics = {"moe_aux_loss": aux, "moe_z_loss": z,
               "moe_drop_frac": 1.0 - torch.mean(keepf)}
    return y.to(x.dtype).reshape(B, S, D), metrics


SERVE_CAPACITY_FACTOR = 2.0     # serve-time: generous, dropless at small T


def moe_apply(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              strategy: str = "einsum",
              capacity_factor: float = CAPACITY_FACTOR):
    if strategy == "sort":
        return moe_apply_sort(cfg, p, x, capacity_factor)
    return moe_apply_einsum(cfg, p, x, capacity_factor)

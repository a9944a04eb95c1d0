"""AdamW with decoupled weight decay and global-norm clipping.

Optimizer state is a tree congruent with params (nested dicts of
tensors, :mod:`repro_torch.optim.tree`).  All math in float32 regardless
of the param dtype, as in the JAX package; nothing is updated in place,
so a step is a function from the old state to the new one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.optim.tree import Tree, leaves, tree_map, unflatten_like


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor       # int32 scalar
    mu: Tree                 # first moment
    nu: Tree                 # second moment


def adamw_init(params: Tree, mu_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=mu_dtype, device=p.device)

    ls = leaves(params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32,
                         device=ls[0].device if ls else None),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Tree) -> torch.Tensor:
    ls = leaves(tree)
    if not ls:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in ls))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_update(grads: Tree, state: AdamWState, params: Tree, *,
                 lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0,
                 norm_fn: Callable[[Tree], torch.Tensor] = global_norm
                 ) -> Tuple[Tree, AdamWState, Dict[str, Any]]:
    """One AdamW step. Returns (new_params, new_state, metrics).
    ``norm_fn`` is the trees' global norm (for clipping and the metrics);
    a tensor-parallel step passes one that sums over its shards.  Each
    leaf is clipped as it is updated (the values of
    :func:`clip_by_global_norm`), so no clipped copy of the whole
    gradient tree is held."""
    gnorm = norm_fn(grads)
    scale = (_clip_scale(gnorm, max_grad_norm)
             if max_grad_norm and max_grad_norm > 0 else None)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    def upd(g, m, v, p):
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        g32 = g.float()
        m = b1 * m + (1.0 - b1) * g32
        v = b2 * v + (1.0 - b2) * torch.square(g32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    outs = [upd(g, m, v, p) for g, m, v, p in
            zip(leaves(grads), leaves(state.mu), leaves(state.nu),
                leaves(params))]
    new_state = AdamWState(step=step,
                           mu=unflatten_like(params, [o[1] for o in outs]),
                           nu=unflatten_like(params, [o[2] for o in outs]))
    metrics = {"grad_norm": gnorm,
               "param_norm": norm_fn(params),
               "lr": torch.as_tensor(lr).to(torch.float32)}
    return unflatten_like(params, [o[0] for o in outs]), new_state, metrics

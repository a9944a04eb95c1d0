"""Reference AdamW with global-norm clipping, decoupled weight decay on
every leaf and the warmup-then-cosine learning rate, from the constants
the traffic file states."""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def learning_rate(opt: Dict, step: int) -> float:
    """The rate of the update that follows ``step`` completed steps."""
    lr, warm, total = (opt["learning_rate"], opt["warmup_steps"],
                       opt["total_steps"])
    if step < warm:
        return lr * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    final = opt["final_frac"]
    return lr * (final + (1.0 - final) * 0.5 * (1.0 + math.cos(math.pi * frac)))


@torch.no_grad()
def clipped(grads: List[torch.Tensor], opt: Dict) -> List[torch.Tensor]:
    """The gradients as the update uses them: scaled so that their global
    norm is at most ``max_grad_norm``."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
    scale = min(1.0, opt["max_grad_norm"] / max(float(norm), 1e-12))
    return [g * scale for g in grads]


@torch.no_grad()
def update(params: List[torch.Tensor], grads: List[torch.Tensor],
           m: List[torch.Tensor], v: List[torch.Tensor], step: int,
           opt: Dict) -> None:
    """One step in place; ``grads`` already clipped; ``step`` the number
    of steps completed before this one."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    lr = learning_rate(opt, step)
    t = step + 1
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_(g, alpha=1.0 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        upd = (mi / c1) / (torch.sqrt(vi / c2) + eps) + wd * p
        p.sub_(lr * upd)

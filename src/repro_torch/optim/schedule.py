"""Learning-rate schedules as pure ``step -> lr`` functions.

Each returns a float32 scalar tensor on the step's device (the CPU for a
Python int), by the JAX package's formulas.
"""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_linear(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        s = _steps(step)
        warm = s / max(warmup_steps, 1)
        frac = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        decay = 1.0 - (1.0 - final_frac) * torch.clamp(frac, 0.0, 1.0)
        return lr * torch.where(s < warmup_steps, warm, decay)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        s = _steps(step)
        warm = s / max(warmup_steps, 1)
        frac = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        cos = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
        decay = final_frac + (1.0 - final_frac) * cos
        return lr * torch.where(s < warmup_steps, warm, decay)
    return f

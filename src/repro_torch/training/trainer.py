"""The train step: gradient accumulation, optional int8 error-feedback
gradient compression, and AdamW with a schedule.

``make_train_step`` is the JAX package's pure step as a torch function
``(state, batch) -> (state, metrics)``: nothing is written in place, so
the old state stays valid and :func:`repro_torch.core.psg.trace` can
trace the step.  Gradients come from ``torch.autograd.grad`` of the
model's ``train_loss`` (through ``use_kernels=False``: the kernels have
no backward, as in the reference).  The reference's ``Trainer`` (data,
checkpoints, the ScalAna hooks) comes with ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.psg import scan
from repro_torch.models.api import ModelBundle
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compress import error_feedback_update
from repro_torch.optim.tree import Tree, leaves, tree_map, unflatten_like

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Tree
    opt: AdamWState
    residual: Optional[Tree]      # error-feedback residual (or None)
    step: torch.Tensor            # int32 scalar


def make_train_step(model: ModelBundle, run: RunConfig,
                    lr_fn: Callable[[torch.Tensor], torch.Tensor]
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the pure train-step function (grad-accum + AdamW [+ EF-int8])."""
    nmicro = max(int(run.microbatch), 1)
    compress = run.grad_compress

    def single_grads(params: Tree, batch: Batch):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = model.train_loss(ps, batch)
            grads = torch.autograd.grad(loss, leaves(ps))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                unflatten_like(params, list(grads)))

    def accum_grads(params: Tree, batch: Batch):
        def split(x):
            b = x.shape[0]
            if b % nmicro:
                raise ValueError(f"batch {b} does not split into "
                                 f"{nmicro} microbatches")
            return x.reshape((nmicro, b // nmicro) + x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        zero = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

        def body(carry, mb):
            acc, lsum = carry
            loss, metrics, grads = single_grads(params, mb)
            acc = tree_map(lambda a, g: a + g.float() / nmicro, acc, grads)
            return (acc, lsum + loss / nmicro), metrics

        lzero = torch.zeros((), dtype=torch.float32,
                            device=leaves(params)[0].device)
        (grads, loss), metrics = scan(
            body, (zero, lzero),
            [{k: v[i] for k, v in micro.items()} for i in range(nmicro)],
            name="microbatches")
        return loss, metrics[-1], grads

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        fn = accum_grads if nmicro > 1 else single_grads
        loss, metrics, grads = fn(state.params, batch)
        residual = state.residual
        if compress and residual is not None:
            grads, residual = error_feedback_update(grads, residual)
        lr = lr_fn(state.step)
        params, opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, lr=lr,
            weight_decay=run.weight_decay)
        # "loss" last: under grad accumulation `metrics` carries the last
        # microbatch's values, but the step loss is the microbatch mean
        out = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(params=params, opt=opt, residual=residual,
                          step=state.step + 1), out

    return train_step

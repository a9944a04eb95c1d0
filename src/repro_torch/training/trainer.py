"""Trainer on torch: the train step, its state, and the training loop.

``make_train_step`` is the JAX package's pure step as a torch function
``(state, batch) -> (state, metrics)``: nothing is written in place, so
the old state stays valid and :func:`repro_torch.core.psg.trace` can
trace the step.  Gradients come from ``torch.autograd.grad`` of the
model's ``train_loss`` (through ``use_kernels=False``: the kernels have
no backward, as in the reference).

Data parallelism is the step's own, not a compiler's: under
:func:`repro_torch.distributed.axes.use_rules` with a mesh, the step
averages its gradients and its loss over the mesh's ``data`` axis with
one bucketed all-reduce, which the traced PSG holds as a Comm vertex.
It does so at every scale, one rank included, so the PSGs of a scaling
series have the same vertices.  Without a mesh it runs no collective.

``Trainer`` is the twin of the reference's: data, the step, checkpoints
and the ScalAna hooks (the sampled ``GraphProfiler``, per-step wall
times, an injected per-rank delay for case studies).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES
from repro_torch.configs import get as get_config
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.core.profiler import GraphProfiler
from repro_torch.core.psg import scan
from repro_torch.data import make_dataset
from repro_torch.distributed.axes import (active_mesh, placements_for,
                                          require_data_parallel, use_rules)
from repro_torch.models.api import ModelBundle, build_model
from repro_torch.models.params import param_specs_tree
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compress import error_feedback_update, init_residual
from repro_torch.optim.tree import Tree, leaves, tree_map, unflatten_like

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Tree
    opt: AdamWState
    residual: Optional[Tree]      # error-feedback residual (or None)
    step: torch.Tensor            # int32 scalar


def data_parallel_mean(loss: torch.Tensor, grads: Tree, mesh
                       ) -> Tuple[torch.Tensor, Tree]:
    """The loss and gradients averaged over ``mesh``'s ``data`` axis: one
    all-reduce of one float32 bucket (every gradient leaf, then the
    loss), so the step has exactly one collective and its loss is the
    global batch's mean.  Summed, then divided by the axis size: a sum is
    the reduction every backend carries on CUDA tensors, Gloo's too (the
    backend of several ranks on one card)."""
    import torch.distributed._functional_collectives as funcol
    require_data_parallel(mesh, "the data-parallel train step")
    gl = leaves(grads)
    flat = torch.cat([g.reshape(-1).float() for g in gl]
                     + [loss.reshape(1).float()])
    n = mesh["data"].size()
    flat = funcol.all_reduce(flat, "sum", mesh.get_group("data")) / n
    out, at = [], 0
    for g in gl:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return flat[at].to(loss.dtype), unflatten_like(grads, out)


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
        mesh = active_mesh()
        if mesh is not None:
            loss, grads = data_parallel_mean(loss, grads, mesh)
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


# ---------------------------------------------------------------------------
# Checkpoint trees
# ---------------------------------------------------------------------------

def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """``state`` as a plain tree of numpy arrays whose paths are the
    manifest keys the JAX package writes for its ``TrainState``
    (``params/...``, ``opt/{step,mu,nu}/...``, ``residual/...``, ``step``;
    no leaf for a ``None`` residual)."""
    def host(t):
        return tree_map(lambda x: x.detach().cpu().numpy(), t)

    tree = {"params": host(state.params),
            "opt": {"step": host(state.opt.step), "mu": host(state.opt.mu),
                    "nu": host(state.opt.nu)},
            "step": host(state.step)}
    if state.residual is not None:
        tree["residual"] = host(state.residual)
    return tree


def state_from_tree(tree: Dict[str, Any], like: TrainState) -> TrainState:
    """The inverse of :func:`state_to_tree`, on ``like``'s devices and
    dtypes."""
    def dev(arrs, ref):
        return tree_map(lambda a, r: torch.from_numpy(np.asarray(a)).to(
            device=r.device, dtype=r.dtype), arrs, ref)

    return TrainState(
        params=dev(tree["params"], like.params),
        opt=AdamWState(step=dev(tree["opt"]["step"], like.opt.step),
                       mu=dev(tree["opt"]["mu"], like.opt.mu),
                       nu=dev(tree["opt"]["nu"], like.opt.nu)),
        residual=(dev(tree["residual"], like.residual)
                  if like.residual is not None else None),
        step=dev(tree["step"], like.step))


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

def to_device(np_batch: Dict[str, np.ndarray], device: torch.device
              ) -> Batch:
    """A numpy batch of the data pipeline on ``device`` (token ids as
    int64, the index type of the models' lookups)."""
    return {k: torch.from_numpy(v).to(
        device=device, dtype=torch.long if v.dtype.kind in "iu" else None)
        for k, v in np_batch.items()}


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """End-to-end training loop (data + step + ckpt + ScalAna).

    ``device`` is ``cuda`` unless the caller asks for ``cpu``; it raises
    without a card.  With a ``mesh`` (a DeviceMesh over the process
    group, :func:`repro_torch.launch.mesh.make_host_mesh`) each rank
    reads its shard of the global batch and the step averages over the
    ``data`` axis."""

    def __init__(self, run: RunConfig, *, mesh=None, rules=None,
                 arch_cfg: Optional[ArchConfig] = None,
                 shape: Optional[ShapeConfig] = None,
                 global_batch: Optional[int] = None,
                 inject_delay: Optional[Dict[int, float]] = None,
                 device: torch.device | str = "cuda"):
        self.run = run
        self.mesh = mesh
        self.rules = rules
        self.device = torch.device(device)
        self.cfg = arch_cfg if arch_cfg is not None else get_config(run.arch)
        self.shape = shape if shape is not None else SHAPES[run.shape]
        self.model = build_model(self.cfg, device=self.device)
        self.lr_fn = warmup_cosine(run.learning_rate, run.warmup_steps,
                                   run.total_steps)
        self.train_step_fn = make_train_step(self.model, run, self.lr_fn)
        self.dataset = make_dataset(self.cfg, self.shape, seed=run.seed,
                                    global_batch=global_batch)
        if mesh is not None:
            self.dataset = self.dataset.shard(mesh["data"].size(),
                                              mesh.get_local_rank("data"))
        self.ckpt = (CheckpointManager(run.checkpoint_dir,
                                       keep=run.keep_checkpoints)
                     if run.checkpoint_dir else None)
        # ScalAna channels
        self.profiler: Optional[GraphProfiler] = None
        self.step_wall_times: list = []
        self.metrics_log: list = []
        # case-study hook: {rank: extra seconds} host-side injected delay
        self.inject_delay = dict(inject_delay or {})

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        params = self.model.init(self.model.generator(
            self.run.seed if seed is None else seed))
        residual = init_residual(params) if self.run.grad_compress else None
        return TrainState(params=params, opt=adamw_init(params),
                          residual=residual,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def state_shardings(self, state: TrainState) -> Optional[TrainState]:
        """``(DeviceMesh, placements)`` per leaf of ``state``: parameters by
        their logical axes under the rules, moments mirroring them,
        scalars replicated.  Like the reference's, ``train`` does not
        apply it."""
        if self.mesh is None:
            return None
        with self._rules():
            specs = param_specs_tree(self.model.specs)

        def like_params():
            return tree_map(lambda spec: (self.mesh, placements_for(
                spec, self.mesh)), specs)

        scalar = (self.mesh, placements_for((), self.mesh))
        return TrainState(
            params=like_params(),
            opt=AdamWState(step=scalar, mu=like_params(), nu=like_params()),
            residual=like_params() if state.residual is not None else None,
            step=scalar)

    # ------------------------------------------------------------------
    def _rules(self):
        return (use_rules(self.mesh, self.rules) if self.mesh is not None
                else contextlib.nullcontext())

    def _put_batch(self, np_batch: Dict[str, np.ndarray]) -> Batch:
        return to_device(np_batch, self.device)

    def enable_scalana(self, state: TrainState, example_batch: Batch) -> None:
        """Build PSG + profiler over the traced train step."""
        with self._rules():
            self.profiler = GraphProfiler(
                self.train_step_fn, (state, example_batch),
                sample_every=self.run.scalana_sample_every,
                max_loop_depth=self.run.max_loop_depth)

    # ------------------------------------------------------------------
    def train(self, num_steps: Optional[int] = None,
              state: Optional[TrainState] = None,
              resume: bool = True,
              step_timeout_s: float = 0.0) -> TrainState:
        num_steps = num_steps or self.run.total_steps
        start_step = 0
        if state is None:
            state = self.init_state()
            if resume and self.ckpt is not None:
                restored = self.ckpt.restore_latest(state_to_tree(state))
                if restored is not None:
                    start_step, tree, _ = restored
                    state = state_from_tree(tree, state)

        if self.run.scalana and self.profiler is None:
            batch0 = self._put_batch(self.dataset.batch(start_step))
            self.enable_scalana(state, batch0)

        step_fn = (self.profiler.step if self.profiler is not None
                   else self.train_step_fn)

        rank = dist.get_rank() if dist.is_initialized() else 0
        with self._rules():
            for i in range(start_step, start_step + num_steps):
                batch = self._put_batch(self.dataset.batch(i))
                t0 = time.perf_counter()
                if self.inject_delay.get(rank):
                    time.sleep(self.inject_delay[rank])  # straggler study
                state, metrics = step_fn(state, batch)
                _fence(self.device)
                dt = time.perf_counter() - t0
                self.step_wall_times.append(dt)
                if step_timeout_s and dt > step_timeout_s:
                    # straggler mitigation: surface instead of hanging
                    self.metrics_log.append({"step": i, "timeout": dt})
                self.metrics_log.append(
                    {"step": i,
                     "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics.get("grad_norm", 0.0)),
                     "wall_s": dt})
                if (self.ckpt is not None and self.run.checkpoint_every
                        and (i + 1) % self.run.checkpoint_every == 0):
                    self.ckpt.save(i + 1, state_to_tree(state))
        if self.ckpt is not None:
            self.ckpt.save(start_step + num_steps, state_to_tree(state),
                           blocking=True)
        return state

    # ------------------------------------------------------------------
    def scalana_artifacts(self):
        """(contracted PSG, per-vertex perf vectors, storage bytes)."""
        if self.profiler is None:
            return None
        return (self.profiler.psg, self.profiler.perf_vectors(),
                self.profiler.storage_bytes())

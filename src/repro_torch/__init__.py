"""ScalAna on PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``repro`` module for module (``checkpoint/``,
``configs/``, ``core/``, ``kernels/``, ``models/``, ``monitor/``,
``optim/``, ``runs/``, ``scenarios/``, ``training/``), so each
counterpart sits at the same path.  The package
imports torch and numpy, never jax and nothing of ``repro``; state made
by the JAX package crosses over as JSON and numpy trees through
:func:`repro_torch.convert.from_reference` and
:func:`repro_torch.convert.params_from_reference`.

Exports resolve lazily (PEP 562): importing the package costs nothing
until a name is used.
"""
from typing import TYPE_CHECKING

# export name -> submodule that defines it
_EXPORTS = {
    "detect_abnormal": "core.detect", "detect_non_scalable": "core.detect",
    "backtrack": "core.backtrack", "root_causes": "core.backtrack",
    "render_report": "core.report",
    "simulate": "core.inject", "simulate_series": "core.inject",
    "build_ppg": "core.ppg",
    "PPG": "core.graph", "PSG": "core.graph", "PerfStore": "core.graph",
    "ShardedStore": "core.shard", "TorchShardView": "core.shard",
    "from_reference": "convert", "params_from_reference": "convert",
    "build_model": "models.api",
    "GraphProfiler": "core.profiler", "build_psg": "core.psg",
    "contract": "core.contraction",
    "TrainState": "training.trainer", "make_train_step": "training.trainer",
    "AdamWState": "optim.adamw", "adamw_init": "optim.adamw",
    "adamw_update": "optim.adamw", "constant": "optim.schedule",
    "warmup_cosine": "optim.schedule", "warmup_linear": "optim.schedule",
    "CheckpointManager": "checkpoint.store",
    "save_checkpoint": "checkpoint.store",
    "load_checkpoint": "checkpoint.store", "latest_step": "checkpoint.store",
    "Monitor": "monitor.aggregator", "MonitorReport": "monitor.aggregator",
    "chaos_run": "monitor.chaos", "socket_chaos_run": "monitor.net",
    "RunStore": "runs.store", "RunRecord": "runs.store",
    "diff_runs": "runs.diff", "align_psgs": "runs.align",
    "cluster_procs": "runs.cluster",
    "render_regression_report": "runs.report",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    module = importlib.import_module(f"{__name__}.{target}")
    value = getattr(module, name)
    globals()[name] = value           # cache: resolve each name once
    return value


def __dir__():
    return __all__


if TYPE_CHECKING:                     # static analyzers see eager imports
    from repro_torch.checkpoint.store import (CheckpointManager,
                                              latest_step, load_checkpoint,
                                              save_checkpoint)
    from repro_torch.convert import from_reference, params_from_reference
    from repro_torch.core.backtrack import backtrack, root_causes
    from repro_torch.core.contraction import contract
    from repro_torch.core.detect import detect_abnormal, detect_non_scalable
    from repro_torch.core.graph import PPG, PSG, PerfStore
    from repro_torch.core.inject import simulate, simulate_series
    from repro_torch.core.ppg import build_ppg
    from repro_torch.core.profiler import GraphProfiler
    from repro_torch.core.psg import build_psg
    from repro_torch.core.report import render_report
    from repro_torch.core.shard import ShardedStore, TorchShardView
    from repro_torch.models.api import build_model
    from repro_torch.monitor.aggregator import Monitor, MonitorReport
    from repro_torch.monitor.chaos import chaos_run
    from repro_torch.monitor.net import socket_chaos_run
    from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
    from repro_torch.optim.schedule import (constant, warmup_cosine,
                                            warmup_linear)
    from repro_torch.runs.align import align_psgs
    from repro_torch.runs.cluster import cluster_procs
    from repro_torch.runs.diff import diff_runs
    from repro_torch.runs.report import render_regression_report
    from repro_torch.runs.store import RunRecord, RunStore
    from repro_torch.training.trainer import TrainState, make_train_step

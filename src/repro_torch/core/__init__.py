"""ScalAna core on PyTorch: graph-based scaling-loss detection.

Pipeline:  build_psg (static, a traced torch program) -> contract ->
GraphProfiler (runtime samples) -> build_ppg / simulate -> detect
(non-scalable + abnormal; numpy or the torch backend, whose fused
detection runs as hand-written CUDA kernels on a card) -> backtrack
(Algorithm 1) -> render_report.  A PSG may also come from the committed
traces, or from the JAX package through
:func:`repro_torch.convert.from_reference`.

Exports resolve lazily (PEP 562) so the numpy analysis layer (graph /
detect / backtrack / inject) imports without paying for torch, which
only the device view and the torch detectors need.
"""
from typing import TYPE_CHECKING

# export name -> submodule that defines it
_EXPORTS = {
    "Path": "backtrack", "backtrack": "backtrack",
    "backtrack_batched": "backtrack", "backtrack_one": "backtrack",
    "backtrack_scalar": "backtrack", "root_causes": "backtrack",
    "CommLog": "commdep", "add_comm_edges": "commdep",
    "annotate_from_hlo": "commdep",
    "contract": "contraction", "GraphProfiler": "profiler",
    "build_psg": "psg", "scan": "psg",
    "Abnormal": "detect", "NonScalable": "detect",
    "MERGE_STRATEGIES": "detect", "JIT_STRATEGIES": "detect",
    "detect_abnormal": "detect", "detect_non_scalable": "detect",
    "fit_loglog": "detect",
    "BRANCH": "graph", "CALL": "graph", "COMM": "graph", "COMP": "graph",
    "LOOP": "graph", "ROOT": "graph",
    "CommIndex": "graph", "CounterColumns": "graph", "EdgeSet": "graph",
    "PPG": "graph", "PSG": "graph",
    "PerfStore": "graph", "PerfVector": "graph", "Vertex": "graph",
    "collective_bytes_total": "hlo", "parse_collectives": "hlo",
    "simulate": "inject", "simulate_series": "inject",
    "p2p_rounds": "inject", "seeded_base_times": "inject",
    "vectorized_base_times": "inject",
    "TorchShardView": "shard", "PerfShard": "shard",
    "ShardedStore": "shard", "shard_ranges": "shard",
    "build_ppg": "ppg",
    "render_report": "report",
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


# `backtrack` is the one export whose name collides with its defining
# submodule: a direct `import repro_torch.core.backtrack` would bind the
# module onto this package and shadow the function.  Pin the function
# eagerly (the submodule is pure numpy).
from repro_torch.core.backtrack import backtrack  # noqa: E402


if TYPE_CHECKING:                     # static analyzers see eager imports
    from repro_torch.core.backtrack import (Path, backtrack,
                                            backtrack_batched,
                                            backtrack_one, backtrack_scalar,
                                            root_causes)
    from repro_torch.core.commdep import (CommLog, add_comm_edges,
                                          annotate_from_hlo)
    from repro_torch.core.contraction import contract
    from repro_torch.core.detect import (Abnormal, JIT_STRATEGIES,
                                         MERGE_STRATEGIES, NonScalable,
                                         detect_abnormal,
                                         detect_non_scalable, fit_loglog)
    from repro_torch.core.graph import (BRANCH, CALL, COMM, COMP, LOOP, ROOT,
                                        CommIndex, CounterColumns, EdgeSet,
                                        PPG, PSG, PerfStore, PerfVector,
                                        Vertex)
    from repro_torch.core.hlo import collective_bytes_total, parse_collectives
    from repro_torch.core.inject import (p2p_rounds, seeded_base_times,
                                         simulate, simulate_series,
                                         vectorized_base_times)
    from repro_torch.core.ppg import build_ppg
    from repro_torch.core.profiler import GraphProfiler
    from repro_torch.core.psg import build_psg, scan
    from repro_torch.core.report import render_report
    from repro_torch.core.shard import (PerfShard, ShardedStore,
                                        TorchShardView, shard_ranges)

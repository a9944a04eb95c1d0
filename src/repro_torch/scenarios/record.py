"""Record real-model step traces for the scenario bank, on torch.

The twin of the JAX package's ``repro.scenarios.record``.  Per trace:

  * :class:`~repro_torch.core.profiler.GraphProfiler` samples the real
    smoke step in this one process (no mesh) — train state / KV cache
    stay RESIDENT between steps (``_RESIDENT``), so a second record of
    the same trace reuses warm state; its contracted PSG and measured
    vertex times are the trace's PSG and ``base``;
  * the sharded step is built through
    :func:`repro_torch.launch.shardings.build_cell` for rank 0 of a
    world of ``N_DEVICES`` ranks on a ``(N_DEVICES / model_axis,
    model_axis)`` mesh, inside a fake process group, and traced: every
    Comm vertex of that PSG is one collective of the rank's program,
    its replica groups classified into a scale-free pattern
    (:func:`classify_groups`) and aggregated per (kind, pattern) into
    :class:`CollectiveSpec` rows under the reference's kind names.

Where the reference compiles the sharded step on forced host devices
and walks its HLO, the port traces it; where the reference profiles the
step sharded over those devices, the port profiles it in one process.
Traces go to a directory the caller names; the committed traces under
``scenarios/traces/`` are the JAX package's recordings and are not
re-recorded.

    python -m repro_torch.scenarios.record --out-dir DIR [names...]
    python -m repro_torch.scenarios.record --out-dir DIR --device cpu
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.graph import COMM, PSG
from repro_torch.core.profiler import GraphProfiler
from repro_torch.distributed.axes import axis_sizes
from repro_torch.launch.mesh import fake_process_group, make_host_mesh
from repro_torch.launch.shardings import build_cell
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init
from repro_torch.optim.schedule import constant
from repro_torch.scenarios.source import (CollectiveSpec, StepTrace,
                                          classify_groups, save_trace)
from repro_torch.training.trainer import TrainState, make_train_step

N_DEVICES = 8
PROFILE_STEPS = 4
SAMPLE_EVERY = 2

# the PSG's comm kinds under the reference's (HLO) names
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

# profile state resident between steps / between record calls: one warm
# (profiler, step args, advance) cell per (arch, kind, device)
_RESIDENT: Dict[Tuple[str, str, str], tuple] = {}


def _mesh_groups(mesh, ranks: List[int]) -> List[List[int]]:
    """Every group of the mesh dim whose group through rank 0 is
    ``ranks`` (the replica groups an HLO collective lists)."""
    grid = mesh.mesh
    for d in range(grid.dim()):
        groups = grid.movedim(d, -1).reshape(-1, grid.shape[d]).tolist()
        if ranks in groups:
            return groups
    return [ranks]


def _collective_specs(psg: PSG, mesh) -> List[CollectiveSpec]:
    """Traced PSG -> aggregated per-(kind, pattern) collective rows, in
    program order (each Comm vertex once, as an HLO op appears once)."""
    n = mesh.mesh.numel()
    buckets: Dict[tuple, CollectiveSpec] = {}
    comms = [v for v in psg.vertices if v.kind == COMM]
    for order, v in enumerate(comms):
        (ranks,) = v.meta["replica_groups"]
        pattern = classify_groups(_mesh_groups(mesh, ranks), n)
        kind = KINDS.get(v.comm_kind, v.comm_kind)
        key = (kind, pattern.layout, pattern.size)
        spec = buckets.get(key)
        if spec is None:
            buckets[key] = CollectiveSpec(kind=kind, bytes=float(v.comm_bytes),
                                          count=1, pattern=pattern,
                                          order=order)
        else:
            spec.bytes += float(v.comm_bytes)
            spec.count += 1
    return sorted(buckets.values(), key=lambda c: c.order)


def _profile(key: Tuple[str, str, str], make_cell: Callable
             ) -> GraphProfiler:
    """Run PROFILE_STEPS through a resident profiler cell."""
    cell = _RESIDENT.get(key)
    if cell is None:
        cell = _RESIDENT[key] = make_cell()
    prof, step_args, advance = cell
    for _ in range(PROFILE_STEPS):
        step_args = advance(prof, step_args)
    _RESIDENT[key] = (prof, step_args, advance)
    return prof


def _sharded(arch: str, cfg, shape_name: str, shape: ShapeConfig,
             model_axis: int):
    """The collective rows and mesh of the cell traced for rank 0."""
    with fake_process_group(N_DEVICES):
        mesh = make_host_mesh(model_axis, device="cpu")
        cell = build_cell(arch, shape_name, mesh, cfg=cfg, shape=shape)
        specs = _collective_specs(cell.lower().psg, mesh)
        return specs, axis_sizes(mesh)


def _trace(name, arch, kind, prof, specs, sizes, **meta) -> StepTrace:
    perf = prof.perf_vectors()
    return StepTrace(
        name=name, arch=arch, kind=kind, psg=prof.psg,
        base={vid: float(v.time) for vid, v in perf.items()},
        collectives=specs, recorded_devices=N_DEVICES, mesh=sizes,
        meta={"sample_every": SAMPLE_EVERY, "profile_steps": PROFILE_STEPS,
              **meta})


def record_train(name: str, arch: str, *, model_axis: int = 2,
                 device: Optional[torch.device | str] = None) -> StepTrace:
    cfg = get_smoke(arch).replace(remat=False)
    dev = torch.device("cuda" if device is None else device)
    B, S = 4, 32

    def make_cell():
        model = build_model(cfg, device=dev)
        step_fn = make_train_step(model, RunConfig(arch=arch), constant(1e-3))
        params = model.init(model.generator(0))
        state = TrainState(params, adamw_init(params), None,
                           torch.zeros((), dtype=torch.int32, device=dev))
        batch = {"tokens": torch.ones((B, S + 1), dtype=torch.long,
                                      device=dev)}
        prof = GraphProfiler(step_fn, (state, batch),
                             sample_every=SAMPLE_EVERY)

        def advance(prof, args):
            state, batch = args
            state, _ = prof.step(state, batch)
            return (state, batch)

        return prof, (state, batch), advance

    prof = _profile((arch, "train", str(dev)), make_cell)
    shape = ShapeConfig(name="train_smoke", seq_len=S, global_batch=B,
                        kind="train")
    specs, sizes = _sharded(arch, cfg, "train_4k", shape, model_axis)
    return _trace(name, arch, "train", prof, specs, sizes, batch=B, seq=S)


def record_decode(name: str, arch: str, *, model_axis: int = 2,
                  device: Optional[torch.device | str] = None) -> StepTrace:
    cfg = get_smoke(arch).replace(remat=False)
    dev = torch.device("cuda" if device is None else device)
    B, S, PROMPT = 4, 16, 8

    def make_cell():
        model = build_model(cfg, device=dev)
        params = model.init(model.generator(0))
        toks = torch.ones((B, PROMPT), dtype=torch.long, device=dev)
        _, cache = model.prefill(params, {"tokens": toks}, S)

        def serve_step(p, c, tok):
            return model.decode_step(p, c, tok)

        tok = torch.ones((B, 1), dtype=torch.long, device=dev)
        prof = GraphProfiler(serve_step, (params, cache, tok),
                             sample_every=SAMPLE_EVERY)

        def advance(prof, args):
            params, cache, tok = args
            _, cache = prof.step(params, cache, tok)
            return (params, cache, tok)

        return prof, (params, cache, tok), advance

    prof = _profile((arch, "decode", str(dev)), make_cell)
    shape = ShapeConfig(name="decode_smoke", seq_len=S, global_batch=B,
                        kind="decode")
    specs, sizes = _sharded(arch, cfg, "decode_32k", shape, model_axis)
    return _trace(name, arch, "decode", prof, specs, sizes, batch=B,
                  cache_len=S, prompt=PROMPT)


RECORDERS = {
    "tinyllama_train": lambda **kw: record_train(
        "tinyllama_train", "tinyllama-1.1b", **kw),
    "moe_train": lambda **kw: record_train(
        "moe_train", "moonshot-v1-16b-a3b", **kw),
    "tinyllama_decode": lambda **kw: record_decode(
        "tinyllama_decode", "tinyllama-1.1b", **kw),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help=f"of {sorted(RECORDERS)}")
    ap.add_argument("--out-dir", required=True,
                    help="directory the traces are written to")
    ap.add_argument("--device", default=None,
                    help="where the step is profiled (default cuda)")
    args = ap.parse_args(argv)
    for name in args.names or sorted(RECORDERS):
        trace = RECORDERS[name](device=args.device)
        path = save_trace(trace, args.out_dir)
        print(f"recorded {name}: {len(trace.psg.vertices)} vertices "
              f"({len(trace.base)} measured), {len(trace.collectives)} "
              f"collective groups, step={trace.step_time() * 1e3:.1f}ms "
              f"-> {path}")


if __name__ == "__main__":
    main()

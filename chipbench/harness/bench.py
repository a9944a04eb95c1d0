"""One run of one cell:

    python chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell's files by name (:mod:`chipbench.harness.registry`), needs
as many CUDA cards as the cell asks for (it exits 2 otherwise, and never
falls back to the CPU), runs the cell's kind, reads its metrics, and
prints as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decides ``correct``
beside its limit, also printed as the last lines of standard error.
It exits 3, printing no result, if JAX or the JAX package was loaded."""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from chipbench.harness import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_of(args: argparse.Namespace, t_start: float,
            device: str = "cuda") -> Dict:
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    return {"workload": wl["name"], "chips": wl["chips"],
            "config": registry.config(bench, wl["config"]),
            "traffic": registry.traffic(wl["traffic"]),
            "seed": args.seed, "seconds": args.seconds,
            "trace": bool(args.trace), "t_start": t_start,
            "device": device}


def run_rank(cell: Dict, rank: int, world: int, backend: str):
    """A rank of a cell whose traffic sets ``ranks``: its card, a data
    mesh over the group, the cell's kind."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    cell = dict(cell, world=world,
                device=(f"cuda:{torch.cuda.current_device()}"
                        if cell["device"] == "cuda" else cell["device"]))
    mesh = make_host_mesh(device=cell["device"].split(":")[0])
    return registry.kind(cell["traffic"]["kind"]).run(cell, rank, world,
                                                      mesh)


def execute(cell: Dict) -> Dict:
    """The cell's run record, in this process or one process a rank."""
    world = int(cell["traffic"].get("ranks", 1))
    if world > 1:
        from chipbench.harness import ranks
        return ranks.launch(world, "chipbench.harness.bench:run_rank", cell,
                            cell["device"])
    return registry.kind(cell["traffic"]["kind"]).run(cell)


def result_line(cell: Dict, run: Dict, device_name: str) -> Dict:
    bench = registry.benchmark()
    group = "per_layer" if cell["trace"] else "end_to_end"
    run = dict(run, peaks=registry.peaks(device_name),
               sample_every=cell["traffic"].get("sample_every"))
    metrics = {}
    for m in registry.metrics_for(bench, cell["workload"], group):
        value = registry.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name,
              "count": int(cell["traffic"].get("ranks", 1)),
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    out = {"correct": bool(run["correct"]), "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": device}
    trace = run.get("trace")
    if cell["trace"] and trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
    out["checks"] = run["checks"]
    return out


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = cell_of(args, t_start)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"chipbench: {cell['workload']} needs {cell['chips']} CUDA "
              f"card(s), found {found}", file=sys.stderr)
        return 2
    run = execute(cell)
    leaked = forbidden_modules()
    if leaked:
        print(f"chipbench: loaded {', '.join(leaked)}: the run may import "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    line = result_line(cell, run, torch.cuda.get_device_name(0))
    if run.get("smi") is not None:
        print("chipbench smi " + json.dumps(run["smi"]), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

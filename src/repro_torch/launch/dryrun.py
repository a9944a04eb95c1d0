"""Multi-pod dry run on torch: price every cell of the production meshes.

The twin of the JAX package's ``launch/dryrun.py``.  For every
(architecture x input shape) cell and both production meshes (16x16
over 256 ranks, 2x16x16 over 512) this module takes one rank of a fake
process group of that size (``launch/mesh.py::fake_process_group``:
collectives are recorded, nothing moves), builds the cell
(``launch/shardings.py::build_cell``), traces it over fake tensors
(``Cell.lower()``) and walks the traced FX graph
(``core/fx_walk.py::walk``) for the rank's FLOPs, bytes, collectives and
memory.  It writes one JSON a cell with the reference's keys and file
names.  It runs nothing on a device and compiles nothing: ``compile_s``
is 0 and ``lower_s`` is the traces' seconds.  Its roofline is three
bounds for a 256- or 512-card H100 cluster, from data-sheet figures
(``launch/mesh.py``: bf16 tensor-core peak, HBM3, NVLink 4 inside an
8-card node and one NDR InfiniBand port a card between nodes, each
collective over the link its group needs); no run has measured them.

Depth.  ``make_fx`` unrolls every layer, so a trace at a published depth
takes minutes.  Each cell is traced at one and two blocks instead (a
hybrid at 1, 2 and ``attn_every`` + 1 layers, which adds its shared
block's second site; an encoder-decoder at (1, 1), (2, 1) and (1, 2)
encoder and decoder blocks), and its FLOPs, bytes, collectives and
memory are extrapolated linearly to the published depth.  That is exact
for these uniform stacks; two numbers are estimates: the peak of live
temporaries, and the raw aggregate's bytes, where a view of a layer of
a stacked cache counts the whole stack.
The artifact records ``depth: {"traced": [...], "extrapolated_to":
L}``.  ``--layers N`` keeps one trace at N blocks instead, and the
artifact says so.

Usage:
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k \\
        --mesh single --opt seq_shard --graph-out artifacts/fx
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.configs import ARCHS, SHAPES, get, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.fx_walk import FxCost, walk
from repro_torch.core.graph import COMM
from repro_torch.launch import shardings
from repro_torch.launch.mesh import (HBM_BANDWIDTH, IB_BANDWIDTH,
                                     NVLINK_BANDWIDTH, PEAK_FLOPS_BF16,
                                     cost_analysis_dict, fake_process_group,
                                     make_production_mesh, mesh_chip_count)

ARTIFACT_DIR = "artifacts/dryrun_torch"
MESHES = {"16x16": False, "2x16x16": True}          # name -> multi_pod
OPTIONS = {"baseline": {}, "gather_weights": {"gather_weights": True},
           "seq_shard": {"seq_shard": True}}
HARDWARE = {"card": "NVIDIA H100 SXM (data sheet)",
            "peak_flops_bf16": PEAK_FLOPS_BF16,
            "hbm_bandwidth": HBM_BANDWIDTH,
            "nvlink_bandwidth": NVLINK_BANDWIDTH,
            "ib_bandwidth": IB_BANDWIDTH, "node_cards": 8}


# ---------------------------------------------------------------------------
# cells of the production meshes (also tools_torch/cells_sweep.py's)
# ---------------------------------------------------------------------------

def cut(cfg: ArchConfig, layers: int,
        enc_layers: Optional[int] = None) -> ArchConfig:
    """``cfg`` at its published widths with at most ``layers`` blocks (and
    ``enc_layers`` encoder blocks, ``layers`` when None)."""
    over = {"n_layers": min(cfg.n_layers, layers)}
    if cfg.enc_layers:
        over["enc_layers"] = min(cfg.enc_layers, layers if enc_layers is None
                                 else enc_layers)
    return cfg.replace(**over)


def cells(archs: Iterable[str], shapes: Iterable[str]):
    """The applicable (arch, shape) pairs, in the order given."""
    for arch in archs:
        for shape in shapes:
            if shape_applicable(get(arch), SHAPES[shape])[0]:
                yield arch, shape


@contextlib.contextmanager
def production_mesh(multi_pod: bool) -> Iterator:
    """A production mesh for rank 0 of a fake process group of its size
    (256 or 512), on the CPU; the group is destroyed on exit."""
    n = 512 if multi_pod else 256
    with fake_process_group(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh_chip_count(mesh) == n
        yield mesh


def sweep(meshes: Iterable[str], archs: Iterable[str],
          shapes: Iterable[str], options: Iterable[str],
          layers: int = 2) -> Iterator[Dict]:
    """Trace each cell at ``layers`` blocks; one record a cell: mesh,
    arch, shape, option, ``ok``, the error where it failed, the trace's
    seconds and the number of Comm vertices of its PSG."""
    todo = list(cells(archs, shapes))
    for mesh_name in meshes:
        with production_mesh(MESHES[mesh_name]) as mesh:
            for arch, shape in todo:
                for opt in options:
                    rec = {"mesh": mesh_name, "arch": arch, "shape": shape,
                           "option": opt}
                    t0 = time.perf_counter()
                    try:
                        cell = shardings.build_cell(
                            arch, shape, mesh, cfg=cut(get(arch), layers),
                            options=OPTIONS[opt])
                        traced = cell.lower()
                        rec.update(ok=True, comms=len(
                            traced.psg.by_kind(COMM)))
                    except Exception as e:          # noqa: BLE001
                        rec.update(ok=False,
                                   error=f"{type(e).__name__}: {e}"[:300])
                    rec["seconds"] = round(time.perf_counter() - t0, 2)
                    yield rec


# ---------------------------------------------------------------------------
# the cost of one trace, and its extrapolation over depth
# ---------------------------------------------------------------------------

def cost_vector(cost: FxCost, traced) -> Dict[str, float]:
    """The additive numbers of one trace, flat."""
    ca = cost_analysis_dict(traced)
    vec = {"dot_flops": cost.dot_flops, "mem_bytes": cost.mem_bytes,
           "xla_flops_raw": ca["flops"],
           "xla_bytes_raw": ca["bytes accessed"],
           "argument_bytes": cost.argument_bytes,
           "output_bytes": cost.output_bytes,
           "temp_bytes": cost.temp_bytes, "alias_bytes": cost.alias_bytes,
           "nvlink_bytes": 0.0, "ib_bytes": 0.0}
    for c in cost.collectives:
        vec["nvlink_bytes" if c.intra_node else "ib_bytes"] += c.result_bytes
    for kind, b in cost.coll_bytes.items():
        vec[f"bytes:{kind}"] = b
        vec[f"count:{kind}"] = cost.coll_counts[kind]
    return vec


def depth_plan(cfg: ArchConfig) -> Tuple[List[ArchConfig], List[int]]:
    """The cut configs to trace and the integer weights that combine
    their cost vectors into the published depth's (exact for a uniform
    stack: each block adds the same work)."""
    L = cfg.n_layers
    if cfg.enc_layers:                      # (1, 1), (2, 1), (1, 2)
        E = cfg.enc_layers
        return ([cut(cfg, 1, 1), cut(cfg, 1, 2), cut(cfg, 2, 1)],
                [1 - (E - 1) - (L - 1), E - 1, L - 1])
    if cfg.attn_every:                      # 1, 2, P + 1 layers
        P = cfg.attn_every
        s = -(-L // P)                      # shared-block sites
        return ([cut(cfg, 1), cut(cfg, 2), cut(cfg, P + 1)],
                [1 - (L - 1) + (s - 1) * (P - 1), (L - 1) - P * (s - 1),
                 s - 1])
    return [cut(cfg, 1), cut(cfg, 2)], [2 - L, L - 1]


def combine(vecs: List[Dict[str, float]], weights: List[int]
            ) -> Dict[str, float]:
    keys = sorted({k for v in vecs for k in v})
    return {k: sum(w * v.get(k, 0.0) for v, w in zip(vecs, weights))
            for k in keys}


def depth_of(cfg: ArchConfig) -> List[int]:
    return [cfg.enc_layers, cfg.n_layers] if cfg.enc_layers \
        else [cfg.n_layers]


def trace_cost(arch: str, shape_name: str, mesh, options: Dict[str, bool],
               layers: Optional[int] = None, graph_out: Optional[str] = None,
               cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None
               ) -> Tuple[Dict[str, float], Dict, str]:
    """Trace one cell (at ``layers`` blocks, or at the depth plan's cuts)
    and return its cost vector at the traced or published depth, the
    ``depth`` record and its kind.  ``cfg`` and ``shape`` override the
    published config and ``SHAPES[shape_name]`` (smoke-scale cells)."""
    cfg = get(arch) if cfg is None else cfg
    if layers is not None:
        cfgs, weights = [cut(cfg, layers)], [1]
    else:
        cfgs, weights = depth_plan(cfg)
    vecs, kind = [], ""
    for c in cfgs:
        cell = shardings.build_cell(arch, shape_name, mesh, cfg=c,
                                    shape=shape, options=options)
        traced = cell.lower()
        kind = cell.kind
        vecs.append(cost_vector(walk(traced.graph_module), traced))
        if graph_out:                       # the last traced depth's
            with open(graph_out, "w") as f:
                f.write(traced.graph_module.code)
    depth = {"traced": [depth_of(c) for c in cfgs],
             "extrapolated_to": None if layers is not None
             else depth_of(cfg),
             "published": depth_of(cfg)}
    return combine(vecs, weights), depth, kind


def roofline(vec: Dict[str, float]) -> Dict:
    """Three bounds in seconds a step on one card of the cluster: compute
    (bf16 tensor cores), memory (HBM3) and collectives (each one's result
    bytes over NVLink inside a node, over InfiniBand across nodes)."""
    terms = {"compute_s": vec["dot_flops"] / PEAK_FLOPS_BF16,
             "memory_s": vec["mem_bytes"] / HBM_BANDWIDTH,
             "collective_s": vec["nvlink_bytes"] / NVLINK_BANDWIDTH
             + vec["ib_bytes"] / IB_BANDWIDTH}
    return {**terms, "bottleneck": max(terms, key=terms.get)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = ARTIFACT_DIR,
             graph_out: Optional[str] = None,
             skip_existing: bool = True,
             verbose: bool = True,
             options: Optional[Dict[str, bool]] = None,
             layers: Optional[int] = None,
             mesh=None) -> Dict:
    """Price one cell and write its artifact (``mesh``: the production
    mesh when the caller holds its fake group, else one is made)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    opts = {k: v for k, v in (options or {}).items() if v}
    suffix = ("__opt-" + "-".join(sorted(opts))) if opts else ""
    stem = f"{arch}__{shape_name}__{mesh_name}{suffix}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{stem}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    ok, why = shape_applicable(get(arch), SHAPES[shape_name])
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": why}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    gpath = None
    if graph_out:
        os.makedirs(graph_out, exist_ok=True)
        gpath = os.path.join(graph_out, f"{stem}.fx.py")
    t0 = time.time()
    with (production_mesh(multi_pod) if mesh is None
          else contextlib.nullcontext(mesh)) as m:
        vec, depth, kind = trace_cost(arch, shape_name, m, opts, layers,
                                      gpath)
        chips = mesh_chip_count(m)
    t_lower = time.time() - t0
    roof = roofline(vec)
    kinds = sorted(k.split(":", 1)[1] for k in vec if k.startswith("bytes:"))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": kind, "status": "ok",
        "options": sorted(opts),
        "chips": chips,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "depth": depth,
        "memory": {
            "argument_bytes": int(vec["argument_bytes"]),
            "output_bytes": int(vec["output_bytes"]),
            "temp_bytes": int(vec["temp_bytes"]),
            "alias_bytes": int(vec["alias_bytes"]),
            "peak_bytes": int(vec["argument_bytes"] + vec["temp_bytes"]),
        },
        "cost": {
            # every node's costs.node_costs summed vs. the walk's dot
            # FLOPs and bytes (the roofline's inputs)
            "xla_flops_raw": vec["xla_flops_raw"],
            "xla_bytes_raw": vec["xla_bytes_raw"],
            "dot_flops_per_device": vec["dot_flops"],
            "mem_bytes_per_device": vec["mem_bytes"],
            "collective_bytes_per_device": sum(vec[f"bytes:{k}"]
                                               for k in kinds),
        },
        "collectives": {
            "bytes_by_kind": {k: vec[f"bytes:{k}"] for k in kinds},
            "counts_by_kind": {k: vec[f"count:{k}"] for k in kinds},
            "nvlink_bytes": vec["nvlink_bytes"],
            "ib_bytes": vec["ib_bytes"],
        },
        "roofline": roof,
        "hardware": HARDWARE,
    }
    if gpath:
        rec["graph_path"] = gpath
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        dev_bytes = rec["memory"]["peak_bytes"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}{suffix}: OK "
              f"({kind}; {dev_bytes / 2**30:.2f} GiB/dev args+temp, "
              f"{vec['dot_flops'] / 1e9:.1f} GFLOP/dev, "
              f"bottleneck={roof['bottleneck']}, traced "
              f"{depth['traced']} in {t_lower:.1f}s)", flush=True)
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="'all' or comma-separated architectures")
    ap.add_argument("--shape", default="all",
                    help="'all' or comma-separated shapes")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--graph-out", default=None,
                    help="directory for each cell's traced FX graph code")
    ap.add_argument("--no-skip", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma-separated optimization options "
                         "(gather_weights,seq_shard)")
    ap.add_argument("--layers", type=int, default=None,
                    help="trace at this many blocks, not extrapolated")
    args = ap.parse_args(argv)
    options = {name: True for name in args.opt.split(",") if name}

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures: List[str] = []
    n_ok = n_skip = 0
    t0 = time.time()
    for multi in meshes:
        with production_mesh(multi) as mesh:
            for arch in archs:
                for shape in shapes:
                    try:
                        rec = run_cell(arch, shape, multi_pod=multi,
                                       out_dir=args.out,
                                       graph_out=args.graph_out,
                                       skip_existing=not args.no_skip,
                                       options=options, layers=args.layers,
                                       mesh=mesh)
                        if rec["status"] == "ok":
                            n_ok += 1
                        else:
                            n_skip += 1
                            print(f"[dryrun] {arch} x {shape}: skipped "
                                  f"({rec['reason']})", flush=True)
                    except Exception:                  # noqa: BLE001
                        failures.append(f"{arch} x {shape} x multi={multi}")
                        traceback.print_exc()
    print(f"\n[dryrun] {n_ok} ok, {n_skip} skipped, "
          f"{len(failures)} FAILED in {time.time() - t0:.1f} s", flush=True)
    if failures:
        for f in failures:
            print("  FAIL:", f)
        raise SystemExit(1)


if __name__ == "__main__":
    main()

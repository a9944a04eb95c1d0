"""ScalAna end-user workflow on torch: measured multi-scale profiling ->
root cause.

The twin of the JAX package's ``repro.launch.scaling_profile``, the
paper's four-step usage (§V):

  1. *ScalAna-static*  — PSG from the traced train step, its gradient
     all-reduce a Comm vertex at the root (the step's one collective for
     a config without experts; an MoE step also all-reduces its
     load-balance means once a layer, inside the layer loop).
  2. *ScalAna-prof*    — run the instrumented data-parallel step at
     several job scales: scale n is n worker processes in one process
     group (rendezvous through a file), each running the step on its
     shard of the global batch through ``GraphProfiler``.  The model is
     the smoke config, as the reference's, or with ``--full`` the
     published one; remat is off either way.
  3. *ScalAna-detect*  — fit per-vertex log-log scaling curves across the
     measured series, flag non-scalable + abnormal vertices, run
     backtracking root-cause detection.
  4. *Report*          — source-line report.

One backend serves the whole series, the one its largest scale needs
(``launch/mesh.py``): where the host has fewer cards than that scale has
ranks, every scale runs on Gloo and the ranks time-share one card; that
contention is part of what the series measures.  Every rank's measured
vectors go into its own row of the PPG.

Example:
    python -m repro_torch.launch.scaling_profile --arch mamba2-130m --full \\
        --scales 1,2,4 --steps 12 --batch 4 --seq 2048   # on the card
    python -m repro_torch.launch.scaling_profile --scales 1,2 --device cpu
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Sequence, Tuple

ARTIFACT_DIR = "artifacts/scaling_torch"
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# worker: one rank of one scale
# ---------------------------------------------------------------------------

def _perf_json(perf) -> Dict[str, dict]:
    return {str(vid): {"time": v.time, "time_var": v.time_var,
                       "samples": v.samples, "counters": v.counters}
            for vid, v in perf.items()}


def worker(args) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get, get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.profiler import GraphProfiler
    from repro_torch.data import make_dataset
    from repro_torch.distributed.axes import use_rules
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.schedule import constant
    from repro_torch.training.trainer import (TrainState, make_train_step,
                                              to_device)

    dev = torch.device(args.device)
    backend = init_group(args.rank, args.world, f"file://{args.init_file}",
                         device=dev, timeout_s=args.timeout,
                         backend=args.backend)
    try:
        n, rank = dist.get_world_size(), dist.get_rank()
        cfg = (get if args.full else get_smoke)(args.arch).replace(
            remat=False)
        if args.layers:
            cfg = cfg.replace(n_layers=args.layers)
        model = build_model(cfg, device=dev)
        mesh = make_host_mesh(device=dev)               # (n, 1) data-parallel
        step_fn = make_train_step(model, RunConfig(arch=args.arch),
                                  constant(1e-3))
        data = make_dataset(cfg, ShapeConfig("scale", args.seq, args.batch,
                                             "train")).shard(n, rank)
        batches = [to_device(data.batch(i), dev) for i in range(args.steps)]
        with use_rules(mesh):
            params = model.init(model.generator(0))
            state = TrainState(params=params, opt=adamw_init(params),
                               residual=None,
                               step=torch.zeros((), dtype=torch.int32,
                                                device=dev))
            prof = GraphProfiler(step_fn, (state, batches[0]),
                                 sample_every=args.sample_every)
            for batch in batches:
                state, _ = prof.step(state, batch)
        perf = _perf_json(prof.perf_vectors())
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        every = [None] * n
        dist.all_gather_object(every, (perf, peak))
        if rank == 0:
            out = {
                "n_procs": n,
                "backend": backend,
                "device": str(dev),
                "config": "full" if args.full else "smoke",
                "params": model.param_count(),
                "peak_bytes": [p for _, p in every],
                "psg": prof.psg.to_json(),
                "perf": perf,
                "perf_procs": [p for p, _ in every],
                "step_times": prof.step_times,
                "trace_s": prof.trace_s,
                "storage_bytes": prof.storage_bytes(),
                "overhead": prof.overhead_estimate(),
            }
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(out, f)
            print(f"[worker n={n}] wrote {args.out} ({backend})", flush=True)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# launcher side: spawn scales, detect, report
# ---------------------------------------------------------------------------

def scale_path(out_dir: str, arch: str, n: int) -> str:
    return os.path.join(out_dir, arch, f"scale_{n}.json")


def run_scale(n: int, *, arch: str, steps: int, batch: int, seq: int,
              sample_every: int, out_dir: str, device: str,
              timeout_s: float, backend: str, full: bool = False,
              layers: int = 0) -> str:
    """Profile one scale: ``n`` worker processes, one process group on
    ``backend``.  Raises if a worker fails or outlives ``timeout_s``;
    returns rank 0's JSON path."""
    out = scale_path(out_dir, arch, n)
    base = os.path.join(out_dir, arch)
    os.makedirs(base, exist_ok=True)
    init_file = os.path.join(base, f"rendezvous_{n}")
    if os.path.exists(init_file):          # a FileStore must start empty
        os.remove(init_file)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs: List[Tuple[subprocess.Popen, str]] = []
    try:
        for r in range(n):
            log = os.path.join(base, f"scale_{n}.rank{r}.log")
            cmd = [sys.executable, "-m", "repro_torch.launch.scaling_profile",
                   "--worker", "--rank", str(r), "--world", str(n),
                   "--init-file", init_file, "--arch", arch,
                   "--steps", str(steps), "--batch", str(batch),
                   "--seq", str(seq), "--sample-every", str(sample_every),
                   "--device", device, "--timeout", str(timeout_s),
                   "--backend", backend, "--out", out] + \
                (["--full"] if full else []) + \
                (["--layers", str(layers)] if layers else [])
            with open(log, "w") as f:
                procs.append((subprocess.Popen(cmd, env=env, stdout=f,
                                               stderr=subprocess.STDOUT),
                              log))
        deadline = time.monotonic() + timeout_s
        for p, log in procs:
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"scale {n}: a worker outlived "
                                   f"{timeout_s:.0f} s; log {log}") from None
            if rc != 0:
                with open(log) as f:
                    tail = f.read()[-2000:]
                raise RuntimeError(f"scale {n}: worker exited {rc}:\n{tail}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def load_series(arch: str, scales: Sequence[int], out_dir: str):
    """({n: PSG}, {n: PPG}, {n: raw JSON}) of the measured scales; each
    PPG row is one rank's measured vectors.  Raises unless every scale
    ran on one backend and one config and their PSGs are congruent."""
    from repro_torch.core import PSG, PerfVector, build_ppg
    psgs, series, raws = {}, {}, {}
    for n in scales:
        with open(scale_path(out_dir, arch, n)) as f:
            raw = json.load(f)
        if raw["n_procs"] != n:
            raise ValueError(f"scale {n}'s profile has n_procs "
                             f"{raw['n_procs']}")
        psg = PSG.from_json(raw["psg"])
        perf = {r: {int(vid): PerfVector(**d) for vid, d in p.items()}
                for r, p in enumerate(raw["perf_procs"])}
        psgs[n], raws[n] = psg, raw
        series[n] = build_ppg(psg, n, perf)
    for key in ("backend", "config"):
        seen = {n: raw.get(key) for n, raw in raws.items()}
        if len(set(seen.values())) > 1:
            raise ValueError(f"the scales ran with different {key}s: {seen}")
    check_congruent(psgs)
    return psgs, series, raws


def check_congruent(psgs: Dict[int, "PSG"]) -> None:
    """Raise unless every scale's PSG has the same vertex ids, kinds and
    names: the series is merged by vertex id."""
    items = sorted(psgs.items())
    n0, ref = items[0]
    want = [(v.vid, v.kind, v.name) for v in ref.vertices]
    for n, psg in items[1:]:
        got = [(v.vid, v.kind, v.name) for v in psg.vertices]
        if got != want:
            a, b = next((a, b) for a, b in itertools.zip_longest(want, got)
                        if a != b)
            raise ValueError(f"the PSGs of scales {n0} and {n} differ "
                             f"(first difference {a} vs {b})")


def diagnose(series, *, backend: str = "numpy", device=None):
    """(non-scalable, abnormal at the largest scale, backtracked paths)."""
    from repro_torch.core import (backtrack, detect_abnormal,
                                  detect_non_scalable)
    ns = detect_non_scalable(series, min_share=0.01, backend=backend,
                             device=device)
    top = series[max(series)]
    ab = detect_abnormal(top, backend=backend, device=device)
    return ns, ab, backtrack(top, ns, ab)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init-file", default="")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: keep)")
    ap.add_argument("--scales", default="1,2,4")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sample-every", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a scale's workers may take")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend (default: the one "
                         "the largest scale needs)")
    ap.add_argument("--out", default="")
    ap.add_argument("--out-dir", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    if args.worker:
        worker(args)
        return

    import torch
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("scaling_profile: no CUDA device; pass "
                           "--device cpu to run on the host")
    from repro_torch.launch.mesh import choose_backend
    scales = [int(s) for s in args.scales.split(",")]
    backend = args.backend or choose_backend(args.device, max(scales))
    for n in scales:
        print(f"[scaling_profile] scale {n} ({backend})...", flush=True)
        run_scale(n, arch=args.arch, steps=args.steps, batch=args.batch,
                  seq=args.seq, sample_every=args.sample_every,
                  out_dir=args.out_dir, device=args.device,
                  timeout_s=args.timeout, backend=backend, full=args.full,
                  layers=args.layers)

    from repro_torch.core import render_report
    _, series, _ = load_series(args.arch, scales, args.out_dir)
    ns, ab, paths = diagnose(series, backend="torch", device=args.device)
    print(render_report(series[max(series)], ns, ab, paths))


if __name__ == "__main__":
    main()

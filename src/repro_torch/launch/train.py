"""Training launcher on torch.

The twin of the JAX package's ``repro.launch.train``: smoke-scale
(reduced config, real training) or the published config at a named
shape, on the card unless ``--device cpu``.  ScalAna profiling is on by
default: every run produces a PSG + per-vertex perf vectors, and
``--report`` renders the scaling-loss report at exit, its abnormal
detect on the trainer's device (``ab_fused`` on the card).

Examples:
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --steps 20
    python -m repro_torch.launch.train --arch mamba2-130m --smoke --steps 50 \\
        --ckpt-dir /tmp/ckpt --report --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import SHAPES, get as get_config, get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.training import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config + small shape")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--no-scalana", action="store_true")
    ap.add_argument("--sample-every", type=int, default=8)
    ap.add_argument("--inject-delay", type=float, default=0.0,
                    help="injected per-step delay on this process (case study)")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    run = RunConfig(
        arch=args.arch, shape=args.shape, total_steps=args.steps,
        learning_rate=args.lr, microbatch=args.microbatch,
        warmup_steps=max(args.steps // 10, 1),
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every or max(args.steps // 2, 1),
        scalana=not args.no_scalana,
        scalana_sample_every=args.sample_every,
        grad_compress=args.grad_compress,
    )
    if args.smoke:
        cfg = get_smoke(args.arch)
        shape = ShapeConfig("smoke", args.seq, args.batch, "train")
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]

    inject = {0: args.inject_delay} if args.inject_delay else None
    tr = Trainer(run, arch_cfg=cfg, shape=shape, inject_delay=inject,
                 device=args.device)
    t0 = time.time()
    tr.train(num_steps=args.steps, step_timeout_s=run.step_timeout_s)
    wall = time.time() - t0

    losses = [m["loss"] for m in tr.metrics_log if "loss" in m]
    print(f"[train] {args.arch} ({'smoke' if args.smoke else 'full'}) on "
          f"{tr.device}: {args.steps} steps in {wall:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    if run.scalana and tr.profiler is not None:
        psg, perf, storage = tr.scalana_artifacts()
        ov = tr.profiler.overhead_estimate()
        print(f"[scalana] PSG: {psg.stats()}; storage {storage/1024:.1f} KiB; "
              f"overhead {100*ov.get('overhead_frac', 0):.2f}%")
        if args.report:
            import torch.distributed as dist
            from repro_torch.core import (backtrack, build_ppg,
                                          detect_abnormal, render_report)
            n = dist.get_world_size() if dist.is_initialized() else 1
            ppg = build_ppg(psg, n, perf)
            ab = detect_abnormal(ppg, abnorm_thd=run.abnorm_thd,
                                 backend="torch", device=tr.device)
            paths = backtrack(ppg, [], ab)
            print(render_report(ppg, [], ab, paths))

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(tr.metrics_log, f)


if __name__ == "__main__":
    main()

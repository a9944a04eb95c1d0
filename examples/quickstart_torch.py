"""Quickstart on torch: train a small LM with ScalAna profiling on, then
render the scaling-loss report.

The twin of ``examples/quickstart.py`` on the port's ``Trainer``; the
report's abnormal detect runs ``ab_fused`` on the card.

    python examples/quickstart_torch.py               # the card
    python examples/quickstart_torch.py --device cpu  # the CPU
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.core import (build_ppg, detect_abnormal,  # noqa: E402
                              render_report)
from repro_torch.training import Trainer  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = RunConfig(
        arch="tinyllama-1.1b",
        total_steps=12,
        learning_rate=1e-3,
        warmup_steps=2,
        scalana=True,                 # graph-guided profiling ON
        scalana_sample_every=4,       # instrument every 4th step
    )
    cfg = get_smoke(run.arch)         # reduced same-family config
    shape = ShapeConfig("quickstart", seq_len=64, global_batch=4,
                        kind="train")

    trainer = Trainer(run, arch_cfg=cfg, shape=shape, device=args.device)
    trainer.train(num_steps=run.total_steps)

    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {run.total_steps} steps on {trainer.device}")

    # ScalAna artifacts: contracted PSG + per-vertex perf vectors
    psg, perf, storage = trainer.scalana_artifacts()
    print(f"PSG: {psg.stats()}")
    print(f"profile storage: {storage / 1024:.1f} KiB "
          f"(a full trace would be "
          f"{trainer.profiler.full_trace_bytes() / 2**20:.1f} MiB)")

    ppg = build_ppg(psg, n_procs=1, perf=perf)
    ab = detect_abnormal(ppg, backend="torch", device=trainer.device)
    print("\n" + render_report(ppg, [], ab, []))


if __name__ == "__main__":
    main()

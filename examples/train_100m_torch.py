"""End-to-end run on torch: train a ~100M-parameter LM for a few
hundred steps.

The twin of ``examples/train_100m.py`` on the port's ``Trainer``: the
deterministic data pipeline, AdamW + cosine schedule, gradient
accumulation, async checkpointing with auto-resume (the run is split
into two halves to prove restart-exactness), and ScalAna profiling,
whose report renders at the end.  ``--unbroken`` also trains the same
steps in one run and holds the split run's last loss to it (within
1e-5).  ``--smoke`` swaps the 100M config for a small one of the same
family (CPU tests).

    python examples/train_100m_torch.py [--steps 200]     # the card
    python examples/train_100m_torch.py --device cpu --smoke --steps 4
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import (ArchConfig, RunConfig,  # noqa: E402
                                      ShapeConfig)
from repro_torch.core import (build_ppg, detect_abnormal,  # noqa: E402
                              render_report)
from repro_torch.training import Trainer  # noqa: E402

# ~100M params: 12 x (d=512, ff=2048) + 32k vocab tied-ish
CFG_100M = ArchConfig(
    name="lm-100m", family="dense",
    n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
    d_ff=2048, vocab_size=32000, mlp="swiglu", loss_chunk=64,
    remat=False,
)
CFG_SMOKE = CFG_100M.replace(name="lm-smoke", n_layers=2, d_model=64,
                             n_heads=4, n_kv_heads=2, d_ff=128,
                             vocab_size=256, loss_chunk=16)
RESUME_TOL = 1e-5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a small config of the same family")
    ap.add_argument("--unbroken", action="store_true",
                    help="also train the steps in one run and compare")
    args = ap.parse_args(argv)
    cfg = CFG_SMOKE if args.smoke else CFG_100M

    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    ckpt = tempfile.mkdtemp(prefix="ckpt100m_")
    run = RunConfig(
        arch=cfg.name, total_steps=args.steps, learning_rate=3e-4,
        warmup_steps=max(args.steps // 20, 1),
        microbatch=args.microbatch,
        checkpoint_dir=ckpt, checkpoint_every=max(args.steps // 4, 1),
        scalana=True, scalana_sample_every=max(min(50, args.steps // 4), 1),
    )
    shape = ShapeConfig("train100m", args.seq, args.batch, "train")

    half = args.steps // 2
    t0 = time.time()
    tr1 = Trainer(run, arch_cfg=cfg, shape=shape, device=args.device)
    tr1.train(num_steps=half)                       # first half...
    print(f"[half 1] {half} steps, "
          f"loss {tr1.metrics_log[0]['loss']:.3f} -> "
          f"{tr1.metrics_log[-1]['loss']:.3f}")

    tr2 = Trainer(run, arch_cfg=cfg, shape=shape, device=args.device)
    tr2.train(num_steps=args.steps - half)          # ...auto-resumes
    wall = time.time() - t0
    assert tr2.metrics_log[0]["step"] == half, "must resume, not restart"

    losses = ([m["loss"] for m in tr1.metrics_log]
              + [m["loss"] for m in tr2.metrics_log])
    toks = args.steps * args.batch * args.seq
    print(f"[half 2] resumed at step {half}")
    print(f"\n{args.steps} steps / {toks / 1e6:.1f}M tokens "
          f"in {wall:.0f}s ({toks / wall:.0f} tok/s on {tr2.device})")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(min {min(losses):.3f})")
    if args.steps >= 20:               # fewer steps are too few to judge
        assert losses[-1] < losses[0], "training must reduce loss"

    if args.unbroken:
        tr0 = Trainer(run.replace(checkpoint_dir=""), arch_cfg=cfg,
                      shape=shape, device=args.device)
        tr0.train(num_steps=args.steps)
        want = [m["loss"] for m in tr0.metrics_log]
        gap = max(abs(a - b) for a, b in zip(losses, want))
        print(f"[unbroken] {args.steps} steps in one run: last loss "
              f"{want[-1]:.6f}, split run {losses[-1]:.6f}, max gap "
              f"{gap:.2e} (tol {RESUME_TOL:g})")
        assert gap <= RESUME_TOL, "the split run must equal the unbroken"

    if tr2.profiler is not None:
        psg, perf, storage = tr2.scalana_artifacts()
        ov = tr2.profiler.overhead_estimate()
        print(f"scalana: storage={storage / 1024:.1f}KiB "
              f"overhead={100 * ov.get('overhead_frac', 0):.2f}%")
        ppg = build_ppg(psg, n_procs=1, perf=perf)
        ab = detect_abnormal(ppg, backend="torch", device=tr2.device)
        print("\n" + render_report(ppg, [], ab, []))
    shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()

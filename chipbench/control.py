"""The readings that the limits of ``correct`` are set from, at a cell's
own size on the card.  Not part of a benchmark run:

    python3 chipbench/control.py --workload <name> [--program-seeds 1,2]
        [--fault-seeds 3,4] [--control-seeds 5,6] [--seconds 1]

- ``--program-seeds``: sound runs of the program, the cell's whole run
  (a window of about ``--seconds``), all on one Trainer whose trace is
  made once: the lower readings.
- ``--fault-seeds``: the same with the profiler's fences taken out
  (``repro_torch.core.profiler._fence`` a no-op), so that the sampled
  step records the host's enqueue times: a fault the vertex-time
  numbers have to catch.
- ``--control-seeds``: the plain reference put in the program's place,
  once in the precision below the configuration's (TF32 products for
  float32 with TF32 off) and once with a planted fault (half of each
  batch left out), each held against the reference in the
  configuration's precision: the upper readings.

Prints one JSON line a run: its numbers, and the verdict of the cell's
limits on them (for the control, of the limits on the numbers it has).
Exits 1 if a control or a fault comes out correct or a run gives no
reading, 2 without a card."""
import gc
import json
import os
import sys
import time


def control_readings(cell, seed, device):
    import torch
    from chipbench.harness import weights
    from chipbench.kinds.train import reference_batches
    from chipbench.reference import judge, train as ref_train
    cfg, traffic = cell["config"], cell["traffic"]
    specs = _specs(cfg)
    batches = reference_batches(traffic, cfg["arch"]["vocab_size"], seed,
                                traffic["batch"], device)
    make = lambda: weights.make(specs, seed, device)  # noqa: E731
    opt, at = traffic["optimizer"], traffic["checked_steps"]
    out = {}
    t = time.perf_counter()
    ref = ref_train.follow(make, batches, cfg, opt, "f32", change_at=at)
    keep = ref_train.kept_leaves(ref["grad_norms"])
    for name, kw in (("control_tf32", {"mode": "tf32"}),
                     ("fault_half_batch", {"half_batch": True})):
        other = ref_train.follow(make, batches, cfg, opt, change_at=at,
                                 **kw)
        out[name] = {
            "loss_gap": judge.loss_gap(other["losses"], ref["losses"]),
            "grad_gap": judge.leaf_gap(other["grad_norms"],
                                       ref["grad_norms"], keep),
            "change_gap": judge.leaf_gap(other["change_norms"],
                                         ref["change_norms"], keep)}
    out["seconds"] = time.perf_counter() - t
    out["leaves_left_out"] = sorted(set(ref["grad_norms"]) - set(keep))
    return out


def _specs(cfg):
    """The program's parameter specs: the names, shapes and init kinds
    under which the benchmark makes the weights (no weights are made)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.api import build_model
    return build_model(ArchConfig(**cfg["arch"]), device="cpu").specs


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _no_fences():
    """Takes the profiler's fences out; returns the undo."""
    import repro_torch.core.profiler as profiler
    fence = profiler._fence
    profiler._fence = lambda device: None
    return lambda: setattr(profiler, "_fence", fence)


def main(argv=None):
    import argparse
    import torch
    from chipbench.harness import bench, registry
    from chipbench.kinds import train
    from chipbench.reference import judge
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    limits = registry.limits(args.workload)
    print(json.dumps({"limits": limits}), flush=True)
    passed = []

    def cell(seed):
        return bench.cell_of(argparse.Namespace(
            workload=args.workload, seed=seed, seconds=args.seconds,
            trace=0), time.perf_counter())

    runs = ([(s, "program") for s in _seeds(args.program_seeds)]
            + [(s, "fault_no_fences") for s in _seeds(args.fault_seeds)])
    trainer = train.prepare(cell(runs[0][0])) if runs else None
    for seed, what in runs:
        gc.collect()                # the last seed's state and reference
        torch.cuda.empty_cache()
        undo = _no_fences() if what != "program" else (lambda: None)
        try:
            rec = train.run(cell(seed), trainer=trainer)
        except RuntimeError as e:           # such as running out of memory
            print(json.dumps({"seed": seed, "run": what, "error": str(e)}),
                  flush=True)
            passed.append((seed, what, "gives no reading"))
            continue
        finally:
            undo()
        print(json.dumps({"seed": seed, "run": what,
                          "correct": rec["correct"],
                          "numbers": rec["numbers"]}), flush=True)
        if what != "program" and rec["correct"]:
            passed.append((seed, what, "comes out correct"))
    del trainer
    for seed in _seeds(args.control_seeds):
        out = control_readings(cell(seed), seed, torch.device("cuda"))
        for what in ("control_tf32", "fault_half_batch"):
            nums = out[what]
            ok = judge.verdict(nums, {k: limits[k] for k in nums
                                      if k in limits})
            out[what] = dict(nums, correct=ok)
            if ok:
                passed.append((seed, what, "comes out correct"))
        print(json.dumps(dict(seed=seed, **out)), flush=True)
    for seed, what, why in passed:
        print(f"control: {what} on seed {seed} {why}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.path.join(os.path.dirname(HERE), "src"),
                   os.path.dirname(HERE)] + [
        p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.exit(main())

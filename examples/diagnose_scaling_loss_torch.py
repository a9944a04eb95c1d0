"""The paper's §II motivating experiment, end to end, on torch.

The PyTorch twin of ``examples/diagnose_scaling_loss.py``: a delay is
injected into ONE process of a 64-process SPMD training job.  The delay
is latent: it propagates through communication dependence and surfaces
as waiting time at a collective far from the cause.  ScalAna's
backtracking algorithm recovers the true (process, source-line) root
cause from the Program Performance Graph alone.  Steps 1-4 use the
port only (``repro_torch``); the abnormal-vertex detection runs the
hand-written ``ab_fused`` CUDA kernel on the card.

    python examples/diagnose_scaling_loss_torch.py               # the card
    python examples/diagnose_scaling_loss_torch.py --device cpu  # the CPU
    python examples/diagnose_scaling_loss_torch.py --full  # full width
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get, get_smoke  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core import (COMM, backtrack, detect_abnormal,  # noqa: E402
                              render_report, root_causes)
from repro_torch.core.inject import schedule, simulate  # noqa: E402
from repro_torch.core.profiler import GraphProfiler  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.schedule import constant  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402

N_PROCS = 64
STRAGGLER = 17


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width tinyllama-1.1b, tokens (4, 2049)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # 1. ScalAna-static + ScalAna-prof: PSG + measured per-vertex times
    cfg = get("tinyllama-1.1b") if args.full else get_smoke("tinyllama-1.1b")
    model = build_model(cfg, device=dev)
    params = model.init(model.generator(0))
    state = TrainState(params=params, opt=adamw_init(params), residual=None,
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    shape = (4, 2049) if args.full else (4, 65)
    batch = {"tokens": torch.ones(shape, dtype=torch.long, device=dev)}
    step = make_train_step(model, RunConfig(), constant(1e-3))
    prof = GraphProfiler(step, (state, batch), sample_every=2)
    for _ in range(4):
        state, _ = prof.step(state, batch)
    psg, perf = prof.psg, prof.perf_vectors()

    # 2. the gradient all-reduce every DP step executes (one card runs
    #    none, so attach the comm vertex the 64-process run would have)
    tops = [v.vid for v in psg.vertices if v.parent == psg.root]
    ar = psg.new_vertex(COMM, "psum(grads)", parent=psg.root,
                        source="src/repro_torch/optim/adamw.py:"
                        f"{adamw_update.__code__.co_firstlineno}")
    ar.comm_kind, ar.comm_bytes = "all_reduce", 8e6
    psg.add_edge(tops[-1], ar.vid, "data")
    psg.add_edge(psg.root, ar.vid, "control")

    # 3. inject a straggler into one process of the 64-process PPG
    target = next(v for v in schedule(psg)
                  if psg.vertices[v].kind == "Loop")
    print(f"injected: +500ms on process {STRAGGLER} at "
          f"{psg.vertices[target].source} (vertex {target})\n")
    # prof.base_times() seeds the replay engine's vectorized base_times
    # channel from the measured profile (unprofiled vertices replay at 0)
    res = simulate(psg, N_PROCS, prof.base_times(),
                   inject={(STRAGGLER, target): 0.5})

    # 4. ScalAna-detect: abnormal vertices + backtracking root cause
    ab = detect_abnormal(res.ppg, abnorm_thd=1.3, backend="torch", device=dev)
    paths = backtrack(res.ppg, [], ab)
    print(render_report(res.ppg, [], ab, paths))

    rcs = root_causes(paths, psg, ppg=res.ppg)
    hit = any(node == (STRAGGLER, target) for node, _, _ in rcs)
    print(f"\nroot cause recovered: {hit}")
    return hit


if __name__ == "__main__":
    sys.exit(0 if main() else 1)

"""Chaos smoke of the port: seeded fault-injection runs of the Monitor.

The twin of the JAX package's ``tools/chaos_smoke.py`` on
``repro_torch.monitor``, with every detect on ``backend="torch"`` on
``--device`` (``cuda`` unless the CPU is asked for).  Six scenarios, at
the reference's sizes (64 processes over 8 hosts; 32 over 4 through
sockets):

* ``faulty-clean`` — a clean fleet under heavy drop/dup/delay/ack-loss;
* ``crash-degraded`` — a dead host, an aggregator crash after round 2
  and a restore from the latest snapshot;
* ``outage`` — a window of sends that all fail;
* ``crash-dead-heavy`` — a crash after round 3, a dead host and heavier
  faults;
* ``socket-chaos`` — real loopback TCP through the byte-level chaos
  proxy (connection resets, torn frames, garbage bytes, stalls);
* ``socket-stacked`` — the socket proxy with the in-process faults
  stacked over each host's socket transport.

Each must converge (its detection output, converged store and rendered
report equal to the one-shot reference, with fleet coverage stated), and
its report text, abnormal list and paths must equal the same run on the
numpy backend.  Run from the repository root:

    python3 tools_torch/chaos_smoke_torch.py [--device cpu] [--out FILE]

Exits non-zero on any divergence.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# the reference smoke's heavy fault mix (tools/chaos_smoke.py)
FAULTS = dict(p_drop=0.25, p_dup=0.2, p_delay=0.35, p_ack_loss=0.15)


def report_key(rep):
    """What a Monitor report must agree on across backends: its text, the
    abnormal list (vid, proc, time, typical, ratio) and the paths."""
    return (rep.text,
            [(a.vid, a.proc, a.time, a.typical, a.ratio)
             for a in rep.abnormal],
            [(p.start_reason, p.nodes) for p in rep.paths])


class Tee:
    """A producer's transport that hands every message to each of
    ``outs``: two Monitors fed the same deltas."""

    def __init__(self, *outs):
        self.outs = outs

    def send(self, msg):
        for out in self.outs:
            out.send(msg)


def scenarios(seed: int):
    """(name, runner(**backend kwargs) -> ChaosResult) for the six runs."""
    from repro_torch.monitor import chaos_run, socket_chaos_run

    def with_snapshots(**kw):
        def run(**bk):
            with tempfile.TemporaryDirectory() as d:
                return chaos_run(snapshot_dir=d, **kw, **bk)
        return run

    return [
        ("faulty-clean", lambda **bk: chaos_run(seed=seed, **FAULTS, **bk)),
        ("crash-degraded", with_snapshots(seed=seed + 1, dead_hosts=(2,),
                                          crash_after_round=2)),
        ("outage", lambda **bk: chaos_run(seed=seed + 5, p_drop=0.0,
                                          outages=((4, 12),), **bk)),
        ("crash-dead-heavy", with_snapshots(seed=seed + 4,
                                            crash_after_round=3,
                                            dead_hosts=(0,), p_drop=0.3,
                                            p_dup=0.25, p_delay=0.4)),
        ("socket-chaos", lambda **bk: socket_chaos_run(
            seed=seed + 2, p_reset=0.12, p_tear=0.1, p_garbage=0.15,
            p_stall=0.05, **bk)),
        ("socket-stacked", lambda **bk: socket_chaos_run(
            seed=seed + 3, p_reset=0.15, p_tear=0.12, p_garbage=0.2,
            faulty_wrap=dict(p_drop=0.2, p_dup=0.2, p_ack_loss=0.1,
                             p_delay=0.2), **bk)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Chaos smoke of the port's Monitor (six scenarios).")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every detect (default cuda)")
    ap.add_argument("--out", default=None,
                    help="also write the results and the last converged "
                         "report to this file")
    args = ap.parse_args(argv)

    lines, ok, last = [], True, None
    for name, run in scenarios(args.seed):
        res = run(backend="torch", device=args.device)
        same = report_key(res.report) == report_key(
            run(backend="numpy").report)
        ok &= res.converged and same
        stats = " ".join(f"{k}={v}" for k, v in
                         sorted(res.transport_stats.items()))
        lines.append(f"[{name}] {'converged' if res.converged else 'DIVERGED'}"
                     f"  abnormal={res.abnormal_match} "
                     f"paths={res.paths_match} store={res.store_match} "
                     f"report={res.report_match} torch on {args.device} "
                     f"= numpy: {same} "
                     f"dup_absorbed={res.duplicates_absorbed} "
                     f"applied={res.deltas_applied}  ({stats})")
        last = res
    lines += ["", last.report.text]
    text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if not ok:
        print("chaos smoke FAILED: monitor output diverged from one-shot "
              "or from the numpy backend", file=sys.stderr)
        return 1
    print("\nchaos smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run-store smoke of the port: the multi-run regression service end to end.

The twin of the JAX package's ``tools/run_store_smoke.py`` on
``repro_torch.runs``, with every cross-run diff's slope fits run by
``diff_runs(backend="torch", device=...)`` and checked against the same
diff on the numpy backend:

**A — cross-run diff accuracy.** The ``amdahl_serial_fraction``
scenario is replayed at 512 processes over its scale ladder twice —
once clean (``SerialFraction(frac=0.0)``, ideal scaling) and once
faulted — both runs recorded in a :class:`repro_torch.runs.RunStore`
and compared with ``diff_runs``.  The injected vertex must be flagged
with precision >= 0.8 at k = |truth|, and a clean-vs-clean diff must
flag nothing.

**B — clustered diff at fleet scale.** A synthetic 65536-process train
step with 64 slowed culprit processes is recorded with ``cluster=64``:
the store holds <= 64 behavior representatives (>= 100x row
compression), the diff still flags the slowed vertex via the peak-row
ratio, and the regressed cluster's membership must contain every
culprit process.

Run from the repository root; ``--device cpu`` where there is no card:

    python3 tools_torch/run_store_smoke_torch.py [--device cpu] [--out FILE]

Exits non-zero on any violation.  ``chip_smoke.py`` calls
:func:`part_a` and :func:`part_b` on the card.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.graph import COMM, COMP, PPG, PSG  # noqa: E402

SLOPE_TOL = 1e-12            # relative, float64 (the detection contract)


# -- the fleet workload (the port's copy of the JAX package's
#    benchmarks/bench_graph_scale.py builders) ----------------------------

def halo_ring_pairs(n_procs: int) -> List:
    """Ring-neighbor exchange posted in the standard even/odd interleave
    (all even-sender pairs, then all odd-sender pairs)."""
    return ([(p, (p + 1) % n_procs) for p in range(0, n_procs, 2)]
            + [(p, (p + 1) % n_procs) for p in range(1, n_procs, 2)])


def build_step_psg(n_comp: int = 24, n_procs_hint: int = 8) -> PSG:
    """Synthetic train-step PSG: comp chain with a p2p halo ring, a grouped
    reduce-scatter and a global all-reduce (the GSPMD shapes that matter)."""
    g = PSG()
    root = g.new_vertex("Root", "root")
    g.root = root.vid
    prev = None
    for i in range(n_comp):
        v = g.new_vertex(COMP, f"layer{i}", parent=root.vid,
                         source=f"model.py:{100 + i}")
        v.flops = 1e12
        if prev is not None:
            g.add_edge(prev, v.vid, "data")
        g.add_edge(root.vid, v.vid, "control")
        prev = v.vid
        if i == n_comp // 3:                      # halo exchange ring
            p2p = g.new_vertex(COMM, "ppermute", parent=root.vid,
                               source="model.py:halo")
            p2p.comm_kind, p2p.comm_bytes = "ppermute", 1e6
            p2p.p2p_pairs = halo_ring_pairs(n_procs_hint)
            g.add_edge(prev, p2p.vid, "data")
            g.add_edge(root.vid, p2p.vid, "control")
            prev = p2p.vid
        if i == 2 * n_comp // 3:                  # grouped reduce-scatter
            rs = g.new_vertex(COMM, "reduce_scatter", parent=root.vid,
                              source="model.py:rs")
            rs.comm_kind, rs.comm_bytes = "reduce_scatter", 4e6
            half = n_procs_hint // 2 or 1
            rs.meta["replica_groups"] = [list(range(half)),
                                         list(range(half, n_procs_hint))]
            g.add_edge(prev, rs.vid, "data")
            g.add_edge(root.vid, rs.vid, "control")
            prev = rs.vid
    ar = g.new_vertex(COMM, "psum", parent=root.vid, source="optim.py:60")
    ar.comm_kind, ar.comm_bytes = "all_reduce", 8e6
    g.add_edge(prev, ar.vid, "data")
    g.add_edge(root.vid, ar.vid, "control")
    return g


def build_fleet_ppg(psg: PSG, n_procs: int, slow: float = 1.0):
    """A fleet-scale PPG written straight into a PerfStore: comp columns
    with deterministic per-proc jitter, the heaviest vertex slowed
    ``slow``x on the culprit procs (every 1024th-plus-7), one global
    collective group.  Returns (ppg, slowed_vid, culprit_proc_set)."""
    ppg = PPG(psg, n_procs)
    procs = np.arange(n_procs)
    culprits = procs[procs % 1024 == 7]
    comp = [v.vid for v in psg.vertices if v.kind == COMP]
    heavy = comp[len(comp) // 2]
    for i, vid in enumerate(comp):
        t = np.full(n_procs, 1e-3 * (1 + i % 3))
        t *= 1.0 + 1e-4 * ((procs * 2654435761 % 97) / 97.0)  # jitter
        if vid == heavy and slow != 1.0:
            t[culprits] *= slow
        ppg.perf.set_column(vid, t, counters={"flops": 1e9})
    for v in psg.vertices:
        if v.kind == COMM:
            ppg.perf.set_column(v.vid, np.full(n_procs, 1e-4))
            ppg.comm.add_group(v.vid, tuple(range(n_procs)))
    return ppg, heavy, set(culprits.tolist())


# -- the two parts --------------------------------------------------------

def same_diff(got, want) -> Tuple[bool, str]:
    """Whether two ``RunDiff``s of the same runs agree: the same flagged
    regressions in the same order, the same flags and times on every
    matched vertex, and slopes within ``SLOPE_TOL``."""
    if got.regressed_vids != want.regressed_vids:
        return False, (f"regressions {got.regressed_vids} vs "
                       f"{want.regressed_vids}")
    for a, b in zip(got.deltas, want.deltas):
        if (a.vid_cand, a.regressed, a.base_time, a.cand_time, a.ratio,
                a.peak_ratio) != (b.vid_cand, b.regressed, b.base_time,
                                  b.cand_time, b.ratio, b.peak_ratio):
            return False, f"vertex {b.vid_cand}: {a} vs {b}"
        for x, y in ((a.base_slope, b.base_slope),
                     (a.cand_slope, b.cand_slope)):
            if abs(x - y) > SLOPE_TOL * max(abs(y), 1.0):
                return False, f"vertex {b.vid_cand}: slope {x} vs {y}"
    return len(got.deltas) == len(want.deltas), "matched vertices differ"


def _median_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def part_a(device: str = "cuda", n: int = 512) -> Dict:
    """Part A on ``device``; returns its numbers and ``ok``."""
    from repro_torch.core.detect import fit_slopes as fit_numpy
    from repro_torch.core.detect_torch import fit_slopes
    from repro_torch.runs import RunStore, diff_runs, render_regression_report
    from repro_torch.scenarios import bank
    from repro_torch.scenarios.faults import SerialFraction

    sc = bank.get_scenario("amdahl_serial_fraction")
    psg, plan, trace = sc.build(n)
    scales = [n // 8, n // 4, n // 2, n]
    t0 = time.perf_counter()
    bad = bank.simulate_series(psg, scales, plan.time_at_scale,
                               inject=plan.inject, seed=sc.seed)
    clean = SerialFraction(frac=0.0).plan(trace, psg, n, sc.seed)
    good = bank.simulate_series(psg, scales, clean.time_at_scale,
                                inject=clean.inject, seed=sc.seed)
    sim_s = time.perf_counter() - t0

    torch_kw = dict(backend="torch", device=device)
    with tempfile.TemporaryDirectory() as d:
        store = RunStore(d)
        t0 = time.perf_counter()
        a = store.load(store.record(series=good, meta={"label": "clean"}))
        b = store.load(store.record(series=bad, meta={"label": "faulted"}))
        record_s = time.perf_counter() - t0
        again = store.load(store.record(series=good))
    t0 = time.perf_counter()
    diff = diff_runs(a, b, **torch_kw)
    first_s = time.perf_counter() - t0           # the device's first use
    diff_s = _median_ms(lambda: diff_runs(a, b, **torch_kw)) / 1e3
    quiet = diff_runs(a, again, **torch_kw)
    same, why = same_diff(diff, diff_runs(a, b, backend="numpy"))
    same_quiet, why_quiet = same_diff(quiet,
                                      diff_runs(a, again, backend="numpy"))
    report = render_regression_report(a, b, diff)

    valid = b.curves > 0.0
    fit_ms = _median_ms(lambda: fit_slopes(b.scales, b.curves, valid,
                                           device=device))
    fit_numpy_ms = _median_ms(lambda: fit_numpy(b.scales, b.curves, valid))

    truth = set(int(v) for v in plan.target_vids)
    k = max(1, len(truth))
    hits = sum(1 for v in diff.regressed_vids[:k] if v in truth)
    precision = hits / k
    ok = (precision >= 0.8 and not quiet.regressions and same and same_quiet
          and diff.backend == "torch")
    line = (f"[A] {sc.name} @ {n}: {len(diff.regressions)} regressed, "
            f"precision@{k}={precision:.2f} (floor 0.80), clean-vs-clean "
            f"regressions={len(quiet.regressions)} (want 0), backend "
            f"{diff.backend} on {device} = numpy: {same and same_quiet}"
            + ("" if same else f" ({why})")
            + ("" if same_quiet else f" (clean: {why_quiet})")
            + f"  sim={sim_s:.2f}s record+load={record_s:.3f}s "
            f"diff={diff_s * 1e3:.2f}ms (first {first_s * 1e3:.2f}ms) "
            f"fit_slopes={fit_ms:.3f}ms (numpy {fit_numpy_ms:.3f}ms; "
            f"{b.curves.shape} curves; medians of 5, host clock)  "
            f"{'ok' if ok else 'VIOLATION'}")
    return {"ok": ok, "line": line, "report": report,
            "precision": precision, "quiet": len(quiet.regressions),
            "sim_s": sim_s, "record_s": record_s, "diff_s": diff_s,
            "first_diff_s": first_s,
            "fit_ms": fit_ms, "fit_numpy_ms": fit_numpy_ms}


def part_b(device: str = "cuda", n: int = 65536,
           max_clusters: int = 64) -> Dict:
    """Part B on ``device``; returns its numbers and ``ok``."""
    from repro_torch.runs import RunStore, diff_runs, regressed_cluster

    psg = build_step_psg(n_comp=12, n_procs_hint=8)
    t0 = time.perf_counter()
    good, heavy, culprits = build_fleet_ppg(psg, n, slow=1.0)
    bad, _, _ = build_fleet_ppg(psg, n, slow=2.5)
    build_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        store = RunStore(d)
        t0 = time.perf_counter()
        a = store.load(store.record(ppg=good, cluster=max_clusters))
        b = store.load(store.record(ppg=bad, cluster=max_clusters))
        cluster_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    diff = diff_runs(a, b, backend="torch", device=device)
    diff_s = time.perf_counter() - t0
    same, why = same_diff(diff, diff_runs(a, b, backend="numpy"))

    reps = b.clustering.n_clusters
    compression = b.clustering.compression()
    k = regressed_cluster(b, diff)
    members = set(b.clustering.members(k).tolist()) if k is not None \
        else set()
    flagged = heavy in diff.regressed_vids
    ok = (reps <= max_clusters and compression >= 100.0 and flagged
          and k is not None and culprits <= members and same)
    line = (f"[B] fleet @ {n}: {reps} representatives (<= {max_clusters}), "
            f"compression {compression:.0f}x (floor 100x), slowed vertex "
            f"{'flagged' if flagged else 'MISSED'}, regressed cluster {k} "
            f"holds {len(culprits & members)}/{len(culprits)} culprits "
            f"(members={len(members)}), backend {diff.backend} on {device} "
            f"= numpy: {same}" + ("" if same else f" ({why})")
            + f"  build={build_s:.2f}s record+cluster={cluster_s:.2f}s "
            f"diff={diff_s * 1e3:.2f}ms  {'ok' if ok else 'VIOLATION'}")
    return {"ok": ok, "line": line, "compression": compression,
            "culprits": len(culprits & members), "build_s": build_s,
            "cluster_s": cluster_s, "diff_s": diff_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run-store smoke of the port (parts A and B).")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the slope fits (default cuda)")
    ap.add_argument("--out", default=None,
                    help="also write the smoke report to this file")
    ap.add_argument("--procs-a", type=int, default=512)
    ap.add_argument("--procs-b", type=int, default=65536)
    args = ap.parse_args(argv)

    a = part_a(args.device, args.procs_a)
    b = part_b(args.device, args.procs_b)
    lines = [a["line"]] + [f"    {t}" for t in
                           a["report"].splitlines()[:14]] + [b["line"]]
    text = "\n".join(lines) + "\n"
    print(text, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if not (a["ok"] and b["ok"]):
        print("run-store smoke FAILED", file=sys.stderr)
        return 1
    print("run-store smoke ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

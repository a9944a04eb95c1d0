#!/usr/bin/env python3
"""Chip smoke of the PyTorch / H100 port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout and
drives the port's main path — the scaling-loss diagnosis — on the card:

1. device — the card's name and power limit, and the kernels' build time;
2. kernels vs plain — ``ab_fused`` and ``ns_fused`` (through every op that
   launches them) against their plain PyTorch versions on the same card
   tensors, in float64 and float32, at P = 65536 processes, V = 56
   vertices, S = 4 scales, k = 64; with each kernel's time, its plain
   version's, its bound and one library yardstick, and ``ns_fused``'s
   device time under ``torch.profiler`` (the kernel, and the live op on
   8 shard blocks) beside its CUDA-event time;
3. bank — the six ground-truth scenarios at 2048 processes through
   ``backend="torch"`` on the card, each equal to the numpy backend's run
   and above its accuracy floors;
4. fleet — a 65536-process sharded fleet (tinyllama train trace, data
   stall) with a four-scale series: detect, rewrite 16 rows, detect
   again, which must upload exactly those rows, launch one abnormal and
   one non-scalable op, and equal the numpy backend's answer;
5. model — the flash-attention kernel against its plain version at the
   reference's sweep and at the full-width tinyllama layer (B=4, nq=32,
   nkv=4, S=2048, h=64, causal) in float32 and bfloat16, with its time,
   the plain version's, SDPA's and its bound; then tinyllama-1.1b at full
   width (22 layers, random weights from a seed): ``train_loss`` through
   the kernel against the einsum path at tokens (4, 2049) and against the
   chunked path at (2, 4097), 22 kernel launches per loss; and four
   128-token prompts served: prefill into a 256-token cache, 32 greedy
   tokens each, twice (the same tokens), and the prompts decoded token by
   token from an empty cache agreeing with prefill;
6. ssm — the ``ssd_scan`` kernel against its plain version at the
   reference's sweep, at a sequence shorter than its chunk and at the
   three full-width shapes (mamba2's and zamba2's loss shapes, mamba2's
   32768-token prefill), with its time at each, the plain version's and
   its bounds (its device time under the profiler is read from the
   profiled model runs below, a launch at a time); the
   flash kernel at zamba2's layer (h = 80) in float32 and
   bfloat16 with its time; then mamba2-130m at full width (24 layers,
   random weights from a seed): ``train_loss`` through the kernel against
   the plain path at tokens (8, 2049), a 32768-token prefill both ways
   and once more under the profiler (the SSD kernel's share of it),
   four 128-token prompts served (32 greedy tokens, twice) and decoded
   token by token; then zamba2-2.7b at full width (54 Mamba2 layers, the
   shared attention block at 9 sites): ``train_loss`` both ways at
   (2, 2049), two 128-token prompts served (16 greedy tokens, twice) and
   decoded token by token.

The detection kernels' launch counts are reset just before phase 3 and
read just after phase 4; the kernels' counts of each model path just
before its first loss and just after its serving run.  It exits non-zero, printing no
result, when any check fails, when there is no CUDA card, or when the
port is not next to it.  The last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

P, V, S, K = 65536, 56, 4, 64
K_WIDE = 1500                   # > 1024 candidates in a column's list
N_TOP = 20
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP_OPS_PER_S = 67e12            # float32 outside the tensor cores (same)
TF32_OPS_PER_S = 494.7e12       # dense TF32 on the tensor cores (same)
BF16_OPS_PER_S = 989e12         # dense bf16 on the tensor cores (same)
L2_FLUSH_BYTES = 80 << 20       # written before each cold-L2 timing (> 50 MB)
TOL = {"float64": 1e-12, "float32": 1e-4}
BANK_PROCS = 2048
FLEET_SCALES = (8192, 16384, 32768, 65536)
# (B, nq, nkv, Sq, Sk, h, causal, dtype name): the reference's flash
# sweep (tests/test_kernels.py) and the full-width tinyllama layer
FLASH_SWEEP = [
    (1, 2, 2, 64, 64, 32, True, "float32"),
    (2, 4, 2, 128, 128, 64, True, "float32"),
    (1, 8, 1, 128, 128, 64, True, "float32"),
    (2, 4, 4, 64, 128, 32, False, "float32"),
    (1, 2, 2, 128, 128, 128, True, "float32"),
    (1, 4, 2, 64, 64, 64, True, "bfloat16"),
]
FLASH_FULL = (4, 32, 4, 2048, 2048, 64, True)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:41
PROMPT, MAX_LEN = 128, 256
# (arch, train token shapes, serve batch, new tokens, long prefill or
# None); tinyllama's two shapes take the einsum path, then the chunked
MODELS = [("tinyllama-1.1b", ((4, 2049), (2, 4097)), 4, 32, None),
          ("mamba2-130m", ((8, 2049),), 4, 32, 32768),
          ("zamba2-2.7b", ((2, 2049),), 2, 16, None)]
# (B, S, H, P, N, chunk): the reference's SSD sweep (tests/test_kernels.py),
# a sequence shorter than its chunk, then mamba2-130m's and zamba2-2.7b's
# loss shapes and mamba2-130m's 32768-token prefill
SSD_SWEEP = [
    (1, 64, 2, 32, 16, 32),
    (2, 128, 4, 64, 32, 64),
    (1, 96, 2, 32, 16, 32),
    (2, 100, 3, 16, 8, 64),
    (1, 256, 1, 64, 64, 64),
    (1, 37, 2, 16, 16, 64),
]
SSD_FULL = [(8, 2048, 24, 64, 128, 64), (2, 2048, 80, 64, 64, 64),
            (1, 32768, 24, 64, 128, 64)]
SSD_TOL = 2e-4                   # tests/test_kernels.py:117-120
# full width, relative to max |y| (max |h|): float32 sums of up to
# Q + N = 192 products in another order, ~1e-6 of the largest value;
# 2e-5 leaves a factor of ten
SSD_FULL_TOL = 2e-5
FLASH_ZAMBA = (2, 32, 32, 2048, 2048, 80, True)
# prefill's final states through the kernel vs the plain path, relative
# to their max |h|: the per-layer differences above, carried through 24
# layers of the residual stream
STATE_TOL = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi unavailable"


def kernel_name(mangled: str) -> str:
    """``ab_column<double>`` from the mangled name of a kernel in an
    anonymous namespace: the last <length><name> of the nested name, then
    its template arguments (integers, float, double, bf16)."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = []
    if mangled[i:i + 1] == "I":
        i += 1
        while i < len(mangled) and mangled[i] != "E":
            if mangled.startswith("Li", i):
                j = mangled.index("E", i)
                args.append(mangled[i + 2:j])
                i = j + 1
            elif mangled.startswith("13__nv_bfloat16", i):
                args.append("bf16")
                i += 15
            else:
                args.append({"f": "float", "d": "double"}.get(mangled[i],
                                                              mangled[i]))
                i += 1
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_usage(report: str):
    """(kernel, registers / spills / static shared memory) for each entry
    function in an ``nvcc -Xptxas -v`` report."""
    out, cur, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and cur:
            smem = m.group(2) or "0"
            out.append((cur, f"{m.group(1)} registers, {spill}, "
                             f"{smem} bytes static smem"))
            cur = None
    return out


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_cold(fn, reps: int = 20, warm: int = 3) -> float:
    """``cuda_ms`` with the L2 cache flushed before each timed call: a
    buffer larger than the L2 is written between the events' records."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        flush.fill_(i & 0xFF)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int, ops_per_s: float = FP_OPS_PER_S):
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def flash_bound(q, k, v, causal_flops: int):
    """The flash kernel's bound for its design: bytes read and written once
    over the HBM rate; in f32, three TF32 products per f32 product (3xTF32)
    over the dense TF32 rate, in bf16 one product over the bf16 rate.  Also
    the bound of f32 on the CUDA cores."""
    f32 = q.element_size() == 4
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    design = (bound_ms(n_bytes, 3 * causal_flops, TF32_OPS_PER_S) if f32
              else bound_ms(n_bytes, causal_flops, BF16_OPS_PER_S))
    return design, bound_ms(n_bytes, causal_flops)


# -- phase 2 inputs ------------------------------------------------------

def make_inputs(seed: int = 0):
    """Seeded (S, P, V) times and variances shaped like a real fleet:
    per-vertex base times and log-log scaling slopes (some vertices scale,
    some do not) with process noise, ~2% stragglers (so columns
    flag far more than k entries), ~1% dead readings, values on a 1e-6
    grid (so scores tie), and a root-child subset for the step time."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.uniform(1e-3, 1e-2, (1, 1, V))
    slope = rng.uniform(-1.2, 0.2, (1, 1, V))          # per-vertex scaling
    scale = 2.0 ** np.arange(1 - S, 1.0)[:, None, None]   # P/8 .. P
    t = base * scale ** slope * (1.0 + 0.05 * rng.standard_normal((S, P, V)))
    t *= np.where(rng.random((S, P, V)) < 0.02, 3.0, 1.0)
    t = np.round(np.abs(t), 6)
    t[rng.random((S, P, V)) < 0.01] = 0.0
    var = rng.uniform(0.0, 1e-6, (S, P, V))
    present = rng.random((S, V)) > 0.05
    present[-1] = True
    top = np.sort(rng.choice(V, N_TOP, replace=False)).astype(np.int32)
    dead = rng.random(P) < 0.08
    return t, var, present, top, dead


def rel_err(got, want) -> float:
    """Normwise relative error max|got - want| / max|want|."""
    d = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    return d / scale if scale > 0 else d


def abs_err(got, want) -> float:
    g, w = got.double(), want.double()
    same = (g == w) | (g.isnan() & w.isnan())
    return 0.0 if bool(same.all()) else (g - w).abs().max().item()


def card_tensors(dt):
    import torch
    t_np, var_np, present_np, top_np, dead_np = make_inputs()
    t = torch.from_numpy(t_np).to("cuda", dt)
    var = torch.from_numpy(var_np).to("cuda", dt)
    present = torch.from_numpy(present_np).to("cuda")
    top = torch.from_numpy(top_np).to("cuda")
    logp = torch.log(torch.tensor([P // 8, P // 4, P // 2, P], dtype=dt,
                                  device="cuda"))
    return t, var, present, top, logp, dead_np


def phase_kernels():
    """Every op that launches a kernel, against the plain version on the
    same tensors, in float64 and float32; returns each kernel's max
    absolute error in float64."""
    import numpy as np
    import torch
    from repro_torch.kernels.detect_fused import ops, ref

    err = {"ab_fused": 0.0, "ns_fused": 0.0}
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[1]
        tol = TOL[name]
        t, var, present, top, logp, dead_np = card_tensors(dt)
        live_t = t[-1].contiguous()
        blocks = list(live_t.chunk(8))
        vblocks = list(var[-1].contiguous().chunk(8))

        # ab_fused: full fleet, degraded fleet, external step time, a quiet
        # fleet (the -inf tail), and a k wider than a block
        live_rows = np.flatnonzero(~dead_np)
        pad = np.zeros(P, np.int64)
        pad[:live_rows.size] = live_rows
        mask = np.zeros(P, bool)
        mask[:live_rows.size] = True
        live_d = torch.from_numpy(pad).to("cuda")
        valid_d = torch.from_numpy(mask).to("cuda")
        quiet = torch.full((P, V), 0.25, dtype=dt, device="cuda")
        cases = {   # case: (op args, plain-version args, k)
            "full": (dict(ts=blocks), (live_t, None, {}), K),
            "degraded": (dict(ts=blocks, live=live_d, valid=valid_d),
                         (live_t.index_select(0, live_d), valid_d, {}), K),
            "step": (dict(ts=[live_t], step_time=0.05),
                     (live_t, None, dict(step_time=0.05)), K),
            "quiet": (dict(ts=[quiet]), (quiet, None, {}), K),
            # more candidates per column than a block has threads
            "wide": (dict(ts=blocks), (live_t, None, {}), K_WIDE),
        }
        for case, (kw, (tp, vp, rk), k) in cases.items():
            ts = kw.pop("ts")
            got = ops.fused_abnormal(ts, top, 1.3, 1e-3, k, **kw)
            want = ref.abnormal(tp, vp, top, 1.3, 1e-3, k, **rk)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]), f"ab {case} {name}: order")
            check(torch.equal(got[1], want[1]), f"ab {case} {name}: scores")
            check(int(got[2]) == int(want[2]), f"ab {case} {name}: count "
                  f"{int(got[2])} != {int(want[2])}")
            check(torch.equal(got[3], want[3]), f"ab {case} {name}: typical")
            if dt == torch.float64 and case != "quiet":
                err["ab_fused"] = max(err["ab_fused"], abs_err(got[1], want[1]),
                                      abs_err(got[3], want[3]))
            if case != "quiet":
                check(int(got[2]) > k, f"ab {case}: only {int(got[2])} "
                      "flags, the select path went untested")
            print(f"  ab_fused {case:8s} {name}: order/scores/count/typical "
                  f"exact, {int(got[2])} flagged")

        # ns_fused: stacked (in-kernel and host total), live + 3 hist,
        # merge column
        def ns_check(tag, got, want):
            for i, part in enumerate(("M", "slope", "share")):
                e = rel_err(got[i], want[i])
                check(e <= tol, f"ns {tag} {name}: {part} rel err {e}")
                if dt == torch.float64:
                    err["ns_fused"] = max(err["ns_fused"],
                                          abs_err(got[i], want[i]))
            check(torch.equal(got[3], want[3]), f"ns {tag} {name}: flags")
            print(f"  ns_fused {tag:8s} {name}: M/slope/share within {tol}, "
                  f"flags exact ({int(got[3].sum())} flagged)")

        kw = dict(ideal_slope=-1.0, slope_margin=0.35, min_share=0.0)
        hist0 = torch.zeros((4, 0, V), dtype=dt, device="cuda")
        ns_check("stacked", ops.fused_non_scalable(
            t, var, logp, present, top_idx=top, **kw),
            ref.non_scalable(t, var, hist0, logp, present, top, **kw))
        ns_check("host_tot", ops.fused_non_scalable(
            t, var, logp, present, total_max=0.125, **kw),
            ref.non_scalable(t, var, hist0, logp, present, top,
                             total_max=0.125, **kw))
        hist = ref.merge_all_stack(t[:3], var[:3])
        ns_check("live", ops.fused_non_scalable_live(
            blocks, vblocks, hist, logp, present, top, **kw),
            ref.non_scalable(live_t[None], var[-1][None], hist, logp,
                             present, top, **kw))
        col = ops.merge_scale_column(blocks, vblocks)
        e = rel_err(col, ref.merge_blocks(blocks, vblocks))
        check(e <= tol, f"merge column {name}: rel err {e}")
        print(f"  ns_fused merge    {name}: column within {tol}")

    return err


def time_kernels():
    """Each kernel at the main path's shapes in float64 (the fleet's live
    scale: one 65536 x 56 matrix, three historical columns), its plain
    version on the same tensors, one library yardstick, and its bound."""
    import torch
    from repro_torch.kernels.detect_fused import kernel, ops, ref

    t, var, present, top, logp, _ = card_tensors(torch.float64)
    live_t = t[-1].contiguous()
    tl, vl = live_t[None], var[-1].contiguous()[None]
    hist = ref.merge_all_stack(t[:3], var[:3])
    kw = dict(ideal_slope=-1.0, slope_margin=0.35, min_share=0.0)
    keys = ref.to_key(live_t)
    # read t and top once; write order, scores, count, typical once
    ab_bytes = live_t.numel() * 8 + top.numel() * 4 + K * 12 + V * 8 + 4
    # read t, var, hist, logp, present, top once; write M, slope, share,
    # flags once
    ns_bytes = (8 * (2 * tl.numel() + hist.numel() + logp.numel()
                     + 4 * S * V + 2 * 4 * V)
                + present.numel() + 4 * top.numel() + 4 * V)
    def ab():
        return kernel.ab_fused(live_t, None, top, 1.3, 1e-3, K)

    def ns():
        return kernel.ns_fused(tl, vl, hist, logp, present, top, **kw)

    # the live op as the fleet calls it: the live scale in 8 shard blocks
    blocks, vblocks = list(live_t.chunk(8)), list(vl[0].chunk(8))

    def ns_live():
        return ops.fused_non_scalable_live(blocks, vblocks, hist, logp,
                                           present, top, **kw)

    return {
        "ab_fused": dict(
            ms=cuda_ms(ab),
            # the fleet's steady cycle finds t written by the dirty-row
            # upload, but a caller may find it cold
            cold_ms=cuda_ms_cold(ab),
            plain_ms=cuda_ms(lambda: ref.abnormal(live_t, None, top, 1.3,
                                                  1e-3, K)),
            # torch.sort of the keys down each column: the closest single
            # library call (it finds every order statistic, not two)
            library_ms=cuda_ms(lambda: torch.sort(keys, dim=0)),
            bound=bound_ms(ab_bytes, live_t.numel() * 8 + P * N_TOP)),
        "ns_fused": dict(
            ms=cuda_ms(ns), device_ms=device_ms(ns, "ns_fused"),
            live_device_ms=device_ms(ns_live, "fused_non_scalable_live"),
            live_ms=cuda_ms(ns_live),
            plain_ms=cuda_ms(lambda: ref.non_scalable(tl, vl, hist, logp,
                                                      present, top, **kw)),
            library_ms=None,           # no single library call merges + fits
            bound=bound_ms(ns_bytes, tl.numel() * 7 + 4 * V * S * 12)),
    }



# -- phase 3: the scenario bank -------------------------------------------

def phase_bank():
    from repro_torch.scenarios import SCENARIOS, score_result

    for name, sc in SCENARIOS.items():
        want = sc.run(BANK_PROCS, backend="numpy")
        t0 = time.perf_counter()
        got = sc.run(BANK_PROCS, backend="torch", device="cuda")
        secs = time.perf_counter() - t0
        check([(a.vid, a.proc, a.time, a.typical) for a in got.abnormal]
              == [(a.vid, a.proc, a.time, a.typical) for a in want.abnormal],
              f"bank {name}: abnormal differs from numpy")
        check([d.vid for d in got.non_scalable]
              == [d.vid for d in want.non_scalable],
              f"bank {name}: non-scalable vids differ from numpy")
        for a, b in zip(got.non_scalable, want.non_scalable):
            check(abs(a.slope - b.slope) <= 1e-12 * max(abs(b.slope), 1.0),
                  f"bank {name}: slope {a.slope} vs {b.slope}")
        check([tuple(p.nodes) for p in got.paths]
              == [tuple(p.nodes) for p in want.paths],
              f"bank {name}: paths differ from numpy")
        check([n for n, _, _ in got.reported]
              == [n for n, _, _ in want.reported],
              f"bank {name}: root causes differ from numpy")
        score = score_result(got)
        check(score.passes(sc.truth), f"bank {name}: floors {score.row()}")
        print(f"  {name:26s} {secs:7.3f} s  {score.row()}  "
              f"abnormal={len(got.abnormal)} "
              f"non_scalable={len(got.non_scalable)}")


# -- phase 4: the sharded fleet -------------------------------------------

def fleet_series():
    from repro_torch.core.inject import simulate, vectorized_base_times
    from repro_torch.scenarios import get_scenario

    sc = get_scenario("data_pipeline_stall")
    psg, plan, _ = sc.build(FLEET_SCALES[-1])
    series = {}
    for n in FLEET_SCALES:
        @vectorized_base_times
        def base(procs, vid, n=n):
            return plan.time_at_scale(procs, vid, n)
        inject = plan.inject if n == FLEET_SCALES[-1] else None
        series[n] = simulate(psg, n, base, inject=inject, shards=8).ppg
    return sc, plan, series


def phase_fleet():
    import numpy as np
    from repro_torch.core.detect import detect_abnormal, detect_non_scalable
    from repro_torch.kernels.detect_fused import ops

    t0 = time.perf_counter()
    sc, plan, series = fleet_series()
    print(f"  simulate {list(series)} x shards=8: "
          f"{time.perf_counter() - t0:.1f} s")
    live = series[FLEET_SCALES[-1]]
    ab_kw = dict(abnorm_thd=sc.abnorm_thd, top_k=sc.top_k)

    def detect(backend):
        dev = "cuda" if backend == "torch" else None
        ns = detect_non_scalable(series, backend=backend, device=dev)
        ab = detect_abnormal(live, backend=backend, device=dev, **ab_kw)
        return ns, ab

    def same(got, want, tag):
        ns, ab = got
        ns_ref, ab_ref = want
        check([(a.vid, a.proc, a.time, a.typical) for a in ab]
              == [(a.vid, a.proc, a.time, a.typical) for a in ab_ref],
              f"fleet {tag}: abnormal differs from numpy")
        check([d.vid for d in ns] == [d.vid for d in ns_ref],
              f"fleet {tag}: non-scalable vids differ from numpy")
        for a, b in zip(ns, ns_ref):
            check(abs(a.slope - b.slope) <= 1e-12 * max(abs(b.slope), 1.0),
                  f"fleet {tag}: slope {a.slope} vs {b.slope}")

    first = detect("torch")
    same(first, detect("numpy"), "first detect")
    check(len(first[1]) == sc.top_k, "fleet: first detect flagged too few")
    view = live.device_view("cuda")
    rng = np.random.default_rng(1)
    target = plan.target_vids[0]

    def rewrite(stall: float):
        # 16 hosts stall at the input vertex for ``stall`` seconds: far
        # above every other excess, so they must lead the next ranking
        rows = np.sort(rng.choice(live.n_procs, 16, replace=False))
        live.perf.set_entries(rows, target, stall)
        return rows

    rows = rewrite(1.0)
    ops.reset_launch_counts()
    ns = detect_non_scalable(series, backend="torch", device="cuda")
    check(view.last_upload_rows == 16,
          f"fleet: steady detect uploaded {view.last_upload_rows} rows")
    ab = detect_abnormal(live, backend="torch", device="cuda", **ab_kw)
    check(dict(ops.launch_counts) == {"non_scalable_live": 1, "abnormal": 1},
          f"fleet: steady launches {dict(ops.launch_counts)}")
    steady = dict(ops.launch_counts)
    same((ns, ab), detect("numpy"), "steady detect")
    check({(a.proc, a.vid) for a in ab[:16]}
          == {(int(r), target) for r in rows},
          "fleet: the rewritten rows do not lead the ranking")
    cycle = []
    for i in range(5):
        rewrite(1.0 + i)
        t0 = time.perf_counter()
        detect("torch")
        cycle.append((time.perf_counter() - t0) * 1e3)
    print(f"  steady detect: 16 rows uploaded, launches "
          f"{steady}; cycle {statistics.median(cycle):.3f}"
          f" ms (median of 5, host clock, incl. upload)")
    rewrite(7.0)
    same(profile_cycle(lambda: detect("torch")), detect("numpy"),
         "profiled detect")


# -- phase 5: the model ------------------------------------------------------

def flash_inputs(case, seed):
    import numpy as np
    import torch
    B, nq, nkv, Sq, Sk, h, _, dt = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to("cuda", getattr(torch, dt))
            for s in ((B, nq, Sq, h), (B, nkv, Sk, h), (B, nkv, Sk, h))]


def phase_flash():
    """The flash kernel against its plain version on the same card
    tensors; returns the max absolute error at the full-width f32 shape."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ref

    err = 0.0
    cases = FLASH_SWEEP + [FLASH_FULL + ("float32",),
                           FLASH_FULL + ("bfloat16",)]
    for i, case in enumerate(cases):
        q, k, v = flash_inputs(case, seed=i)
        causal, h, dt = case[6], case[5], case[7]
        got = kernel.flash_attention(q, k, v, causal=causal,
                                     softmax_scale=h ** -0.5)
        want = ref.attention(q, k, v, causal=causal, softmax_scale=h ** -0.5)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        tol = FLASH_TOL[dt]
        ok = bool((d <= tol + tol * want.float().abs()).all())
        check(ok and bool(torch.isfinite(got).all()),
              f"flash {case}: max abs err {d.max().item():.3g} (tol {tol})")
        if case == FLASH_FULL + ("float32",):
            err = d.max().item()
        print(f"  flash {case}: max abs err {d.max().item():.3g} "
              f"within {tol}")
    return err


def time_flash():
    """The kernel at the full-width f32 layer shape, its plain version and
    SDPA (the library yardstick, never on the port's path) on the same
    tensors, and the bound of :func:`flash_bound` for 2 B nq S^2 h causal
    FLOPs (with the f32 CUDA-core bound beside it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref

    case = FLASH_FULL + ("float32",)
    B, nq, nkv, S, _, h, _ = FLASH_FULL
    q, k, v = flash_inputs(case, seed=0)
    scale = h ** -0.5
    bound, core_bound = flash_bound(q, k, v, 2 * B * nq * S * S * h)
    return dict(
        ms=cuda_ms(lambda: kernel.flash_attention(
            q, k, v, causal=True, softmax_scale=scale)),
        plain_ms=cuda_ms(lambda: ref.attention(
            q, k, v, causal=True, softmax_scale=scale), reps=10),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True)),
        bound=bound, core_bound=core_bound)


def phase_model(arch, train, serve_b, new, long_prefill):
    """One model at full width on the card, random weights from seed 0:
    at each train shape the kernel path's loss against the plain path's
    (first calls, then three more of each in turns), one profiled loss,
    a long prefill both ways (where given), and ``serve_b`` prompts served
    twice and decoded token by token.  Checks each loss's kernel launches
    and returns the launches the whole run must have made."""
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.models import build_model
    from repro_torch.models.attention import CHUNKED_ATTN_THRESHOLD
    from repro_torch.models.hybrid import n_attn_sites

    def counts():
        return {"flash_attention": flash.flash_attention.launches,
                "ssd_scan": ssd.ssd_scan.launches}

    cfg = get(arch)
    ssm = cfg.family in ("ssm", "hybrid")
    per_loss = {"flash_attention": cfg.n_layers if cfg.family == "dense"
                else n_attn_sites(cfg) if cfg.family == "hybrid" else 0,
                "ssd_scan": cfg.n_layers if ssm else 0}
    per_prefill = {"flash_attention": 0, "ssd_scan": per_loss["ssd_scan"]}
    losses = prefills = 0
    plain = build_model(cfg)
    kern = build_model(cfg.replace(use_kernels=True))
    t0 = time.perf_counter()
    params = plain.init(plain.generator(0))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  {arch} init: {plain.param_count()} params, "
          f"{n_bytes / 1e9:.2f} GB on the card, "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)

    def tokens(shape):
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, shape, dtype=np.int64)).to("cuda")

    def loss(model, batch):
        """(loss, seconds on the host clock to a synchronised result)"""
        t0 = time.perf_counter()
        value = float(model.train_loss(params, batch)[0])
        return value, time.perf_counter() - t0

    for B, T in train:
        batch = {"tokens": tokens((B, T))}
        before = counts()
        lk, first_k = loss(kern, batch)
        made = {k: n - before[k] for k, n in counts().items()}
        l0, first_0 = loss(plain, batch)
        path = "plain" if ssm else (
            "einsum" if T - 1 <= CHUNKED_ATTN_THRESHOLD else "chunked")
        check(np.isfinite(lk) and np.isfinite(l0),
              f"{arch} loss at {(B, T)}: {lk}, {l0}")
        check(abs(lk - l0) < 1e-3, f"{arch} loss at {(B, T)}: kernel {lk!r} "
              f"vs {path} {l0!r}")
        check(made == per_loss, f"{arch} loss at {(B, T)}: launches {made}, "
              f"expected {per_loss}")
        # steady times: median of 3 more of each, in turns
        secs = {"kernel": [], path: []}
        for _ in range(3):
            for name, model in (("kernel", kern), (path, plain)):
                value, t = loss(model, batch)
                check(abs(value - l0) < 1e-3, f"{arch} loss at {(B, T)}: "
                      f"{name} gave {value!r} on a later call")
                secs[name].append(t)
        losses += 4
        print(f"  {arch} train_loss tokens {(B, T)}: kernel {lk!r}, {path} "
              f"{l0!r}, |diff| {abs(lk - l0):.3g}, launches {made}; first "
              f"call kernel {first_k:.3f} s, {path} {first_0:.3f} s; steady "
              + ", ".join(f"{k} {statistics.median(v):.3f} s"
                          for k, v in secs.items())
              + " (median of 3, host clock)")
    # one kernel-path loss at the first shape under the profiler
    batch = {"tokens": tokens(train[0])}
    got = profile_cycle(lambda: kern.train_loss(params, batch)[0],
                        f"{arch} train_loss", share=("ssd_",) if ssm else
                        ("flash_", "tf32_planes"))
    losses += 1
    check(abs(float(got) - float(plain.train_loss(params, batch)[0])) < 1e-3,
          f"{arch}: the profiled loss differs from the plain path's")

    if long_prefill:
        toks = tokens((1, long_prefill))
        t0 = time.perf_counter()
        klog, kcache = kern.prefill(params, {"tokens": toks}, long_prefill)
        torch.cuda.synchronize()
        tk = time.perf_counter() - t0
        t0 = time.perf_counter()
        plog, pcache = plain.prefill(params, {"tokens": toks}, long_prefill)
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        prefills += 1
        d = (klog - plog).abs().max().item()
        e = rel_err(kcache.ssm.h, pcache.ssm.h)
        ec = rel_err(kcache.ssm.conv, pcache.ssm.conv)
        check(bool(torch.isfinite(klog).all()) and d <= 1e-3,
              f"{arch} prefill {long_prefill}: logits |diff| {d}")
        check(e <= STATE_TOL and ec <= STATE_TOL,
              f"{arch} prefill {long_prefill}: states rel err {e}, conv {ec}")
        print(f"  {arch} prefill 1 x {long_prefill}: kernel {tk:.3f} s, "
              f"plain {tp:.3f} s (host clock, first call); logits max |diff| "
              f"{d:.3g}, final states rel err {e:.3g}, conv {ec:.3g} "
              f"(tol {STATE_TOL})")
        del kcache, pcache
        profile_cycle(lambda: kern.prefill(params, {"tokens": toks},
                                           long_prefill)[0],
                      f"{arch} prefill 1 x {long_prefill}",
                      share=("ssd_",))
        prefills += 1

    prompts = tokens((serve_b, PROMPT))

    def serve():
        logits, cache = kern.prefill(params, {"tokens": prompts}, MAX_LEN)
        first = logits
        out = []
        for _ in range(new):
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
            logits, cache = kern.decode_step(params, cache, tok)
        length = getattr(cache, "kv", cache).length
        check(int(length[0]) == PROMPT + new, f"{arch}: cache length")
        return first, torch.cat(out, 1)

    t0 = time.perf_counter()
    first, toks_a = serve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _, toks_b = serve()
    prefills += 2
    check(torch.equal(toks_a, toks_b), f"{arch}: greedy decode is not "
          "deterministic")
    check(bool(torch.isfinite(first).all()), f"{arch}: prefill logits not "
          "finite")
    cache = kern.init_cache(serve_b, MAX_LEN)
    for i in range(PROMPT):
        step, cache = kern.decode_step(params, cache, prompts[:, i:i + 1])
    d = (first[:, -1] - step[:, -1]).abs().max().item()
    check(d <= 2e-2, f"{arch}: prefill vs token-by-token decode: max |diff| "
          f"{d}")
    print(f"  {arch} served {serve_b} prompts x {PROMPT} tokens + {new} "
          f"greedy tokens in {secs:.2f} s (host clock); second run "
          f"identical; prefill vs decode max |diff| {d:.3g}")
    return {k: per_loss[k] * losses + per_prefill[k] * prefills
            for k in per_loss}


def drive_model(arch, *spec):
    """``phase_model`` with the model kernels' counts set to 0 just before
    it and read just after; fails unless they are what the run must have
    made and some kernel ran."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.ssd_scan import kernel as ssd
    flash.flash_attention.launches = ssd.ssd_scan.launches = 0
    want = phase_model(arch, *spec)
    got = {"flash_attention": flash.flash_attention.launches,
           "ssd_scan": ssd.ssd_scan.launches}
    check(got == want and any(got.values()),
          f"{arch}: launches {got}, expected {want}")
    print(f"  {arch} path launches: {got}")
    return got


def ssd_inputs(case, seed):
    """The reference's ``_ssd_inputs`` (tests/test_kernels.py:98-106) on
    the card."""
    import numpy as np
    import torch
    B, S, H, Pd, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, Pd))
    dt = np.abs(rng.standard_normal((B, S, H))) * 0.1
    A = -(np.abs(rng.standard_normal((H,))) + 0.1)
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    return [torch.from_numpy(a.astype(np.float32)).to("cuda")
            for a in (x, dt, A, Bm, Cm)]


def phase_ssd():
    """The ssd_scan kernel (through the op, which pads ragged sequences)
    against its plain version on the same card tensors; returns the max
    absolute error of y at mamba2's full shape."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref

    err = 0.0
    for case in SSD_SWEEP + SSD_FULL:
        args = ssd_inputs(case, seed=sum(case))
        chunk = case[5]
        y, h = ops.ssd_scan(*args, chunk=chunk, return_final=True)
        yr, hr = ref.ssd_ref(*args, chunk=chunk, return_final=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all()),
              f"ssd {case}: not finite")
        dy, dh = (y - yr).abs().max().item(), (h - hr).abs().max().item()
        if case in SSD_FULL:
            ey, eh = rel_err(y, yr), rel_err(h, hr)
            check(ey <= SSD_FULL_TOL and eh <= SSD_FULL_TOL,
                  f"ssd {case}: rel err y {ey:.3g}, h {eh:.3g} "
                  f"(tol {SSD_FULL_TOL} of max |y|, max |h|)")
            if case == SSD_FULL[0]:
                err = dy
            print(f"  ssd_scan {case}: max abs err y {dy:.3g} h {dh:.3g}; "
                  f"rel to max |y| {ey:.3g}, max |h| {eh:.3g} within "
                  f"{SSD_FULL_TOL}")
        else:
            for g, w in ((y, yr), (h, hr)):
                ok = bool(((g - w).abs() <= SSD_TOL + SSD_TOL * w.abs()).all())
                check(ok, f"ssd {case}: max abs err y {dy:.3g} h {dh:.3g} "
                      f"(tol {SSD_TOL})")
            print(f"  ssd_scan {case}: max abs err y {dy:.3g} h {dh:.3g} "
                  f"within {SSD_TOL}")
    return err


def ssd_bound(case):
    """The least time of the SSD scan at ``case``: x, dt, A, B, C read
    once and y and the final state written once, over the HBM rate; the
    chunked SSD's products, three TF32 products per f32 product (3xTF32)
    over the dense TF32 rate, as the kernel runs them.  Those are C B^T
    on the causal triangle, Q(Q+1)/2 N multiply-adds per (batch row,
    chunk), as B and C are shared by every head; and per (batch row,
    head, chunk) M x on the triangle, Q(Q+1)/2 P, and C h_prev and
    B^T (w x), 2 Q N P.  Also the bound of the same products in f32 on
    the CUDA cores."""
    B, S, H, Pd, N, Q = case
    n_bytes = 4 * (2 * B * S * H * Pd + B * S * H + H + 2 * B * S * N
                   + B * H * N * Pd)
    tri = Q * (Q + 1) // 2
    macs = B * (S // Q) * (tri * N + H * (tri * Pd + 2 * Q * N * Pd))
    return (bound_ms(n_bytes, 3 * 2 * macs, TF32_OPS_PER_S),
            bound_ms(n_bytes, 2 * macs))


def time_ssd():
    """The kernel at each full shape (mamba2-130m's loss shape, zamba2-
    2.7b's, mamba2-130m's 32768-token prefill), its plain version on the
    same tensors, and its bounds; the first shape is the JSON line's row,
    the others are printed.  No single library call computes it."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ref

    out = []
    for case in SSD_FULL:
        Q = case[5]
        args = ssd_inputs(case, seed=sum(case))
        bound, core = ssd_bound(case)
        out.append(dict(
            case=case, ms=cuda_ms(lambda: kernel.ssd_scan(*args, chunk=Q)),
            plain_ms=cuda_ms(lambda: ref.ssd_ref(*args, chunk=Q,
                                                 return_final=True), reps=5),
            library_ms=None, bound=bound, core_bound=core))
        del args
        torch.cuda.empty_cache()
    return out


def phase_flash80():
    """The flash kernel at zamba2-2.7b's attention layer (h = 80) against
    its plain version in f32 and bf16; its time, the plain version's,
    SDPA's and the bound, on a line of their own."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref

    B, nq, nkv, S, _, h, _ = FLASH_ZAMBA
    scale = h ** -0.5
    for dt in ("float32", "bfloat16"):
        q, k, v = flash_inputs(FLASH_ZAMBA + (dt,), seed=7)
        got = kernel.flash_attention(q, k, v, causal=True, softmax_scale=scale)
        want = ref.attention(q, k, v, causal=True, softmax_scale=scale)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        tol = FLASH_TOL[dt]
        check(bool((d <= tol + tol * want.float().abs()).all())
              and bool(torch.isfinite(got).all()),
              f"flash {FLASH_ZAMBA} {dt}: max abs err {d.max().item():.3g}")
        print(f"  flash {FLASH_ZAMBA} {dt}: max abs err "
              f"{d.max().item():.3g} within {tol}")
    q, k, v = flash_inputs(FLASH_ZAMBA + ("float32",), seed=7)
    ms = cuda_ms(lambda: kernel.flash_attention(q, k, v, causal=True,
                                                softmax_scale=scale))
    plain = cuda_ms(lambda: ref.attention(q, k, v, causal=True,
                                          softmax_scale=scale), reps=10)
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    bound, core = flash_bound(q, k, v, 2 * B * nq * S * S * h)
    print(f"  flash_attention {FLASH_ZAMBA} f32: {ms:.4f} ms  plain "
          f"{plain:.4f} ms  bound {bound[0]:.4f} ms ({bound[1]}, 3xTF32; "
          f"CUDA-core f32 {core[0]:.4f} ms)  sdpa {sdpa:.4f} ms  "
          f"kernel/sdpa {ms / sdpa:.3f}")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def profile_cycle(fn, what: str = "detect cycle", share: tuple = ()):
    """One steady detect cycle (or ``what``) under ``torch.profiler``:
    device time per kernel, and the device's busy share of the cycle's
    wall time; with ``share``, the names of one op's kernels, also the
    share of the busy time they take, and their time per launch of the
    first (one a call of the op).  Returns ``fn()``'s result.
    A profiler that cannot trace the card says so and the run goes on; a
    failure of the cycle itself fails the smoke."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ran = False
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            try:
                out = fn()
                torch.cuda.synchronize()
                ran = True
            except Exception as e:
                raise SmokeFailure(f"profiled {what}: "
                                   f"{type(e).__name__}: {e}") from e
            wall = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us / 1e3, e.count, e.key))
    except SmokeFailure:
        raise
    except Exception as e:                     # the profiler's own failure
        print(f"  profiler: no device trace ({type(e).__name__}: {e})")
        return out if ran else fn()
    busy = sum(ms for ms, _, _ in rows)
    print(f"  profiled {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), idle {100 - 100 * busy / wall:.1f}%")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        print(f"    {ms:8.4f} ms  x{n:<3d} {key[:90]}")
    if share:
        mine = [(ms, n, key) for ms, n, key in rows
                if any(name in key for name in share)]
        ms = sum(m for m, _, _ in mine)
        n = sum(c for _, c, key in mine if share[0] in key)
        parts = ", ".join(
            f"*{name}* {sum(m for m, _, k in mine if name in k):.3f} ms"
            for name in share[1:])
        print(f"  *{'* + *'.join(share)}* in {what}: {ms:.3f} ms over {n} "
              f"calls ({ms / max(n, 1):.4f} ms a call)"
              + (f", of which {parts}" if parts else "")
              + f", {100 * ms / busy:.1f}% of device busy, "
              f"{100 * ms / wall:.1f}% of wall")
    return out


def device_ms(fn, what: str, reps: int = 5):
    """Device time of one ``fn()`` (``what``) under ``torch.profiler``:
    every CUDA kernel, copy and set it runs, summed, in each of ``reps``
    profiled calls (one profiler session a call, after a warm-up call);
    the median, or None when the profiler traces no device time.  A
    failure of ``fn()`` fails the smoke."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times = []
    try:
        for _ in range(reps):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                try:
                    fn()
                    torch.cuda.synchronize()
                except Exception as e:
                    raise SmokeFailure(f"profiled {what}: "
                                       f"{type(e).__name__}: {e}") from e
            total = 0.0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    us = getattr(e, "self_device_time_total", None)
                    total += e.self_cuda_time_total if us is None else us
            times.append(total / 1e3)
    except SmokeFailure:
        raise
    except Exception as e:                     # the profiler's own failure
        print(f"  profiler: no device trace ({type(e).__name__}: {e})")
        return None
    ms = statistics.median(times)
    return ms if ms > 0 else None


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not importable", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
        from repro_torch.kernels.detect_fused import kernel
        from repro_torch.kernels.flash_attention import kernel as flash
        from repro_torch.kernels.ssd_scan import kernel as ssd
    except ImportError as e:
        print(f"FAIL: the port is not next to this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    try:
        t0 = time.perf_counter()
        spent = _build.build([*kernel.LIBRARIES.values(), flash.LIBRARY,
                              ssd.LIBRARY])
        wall = time.perf_counter() - t0
        print(f"[device] {card}; kernels built in {wall:.1f} s "
              + ", ".join(f"{n} {s:.1f} s" for n, s in spent.items()))
        for n, report in _build.BUILD_LOG.items():
            for kern, usage in ptxas_usage(report):
                print(f"  {n}: {kern}: {usage}")
        print(f"[kernels vs plain] P={P} V={V} S={S} k={K}, {card}")
        err = phase_kernels()
        timing = time_kernels()
        for n, tm in timing.items():
            lib = "null" if tm["library_ms"] is None else \
                f"{tm['library_ms']:.4f}"
            print(f"  {n}: {tm['ms']:.4f} ms  plain {tm['plain_ms']:.4f} ms  "
                  f"bound {tm['bound'][0]:.4f} ms ({tm['bound'][1]})  "
                  f"library {lib} ms  max_abs_err {err[n]:.3g}  [{card}]")
        nst = timing["ns_fused"]
        print("  ns_fused device time (torch.profiler, median of 5): kernel "
              + ("not traced" if nst["device_ms"] is None else
                 f"{nst['device_ms']:.4f} ms")
              + ", fused_non_scalable_live on 8 shard blocks "
              + ("not traced" if nst["live_device_ms"] is None else
                 f"{nst['live_device_ms']:.4f} ms")
              + f" (CUDA events {nst['ms']:.4f} ms, live op "
              f"{nst['live_ms']:.4f} ms)  [{card}]")
        ab = timing["ab_fused"]
        print(f"  ab_fused cold L2: {ab['cold_ms']:.4f} ms (warm "
              f"{ab['ms']:.4f} ms); kernel / torch.sort of the keys "
              f"{ab['ms'] / ab['library_ms']:.3f} warm  [{card}]")
        kernel.reset_launches()
        print(f"[bank] {BANK_PROCS} procs, backend=torch on cuda vs numpy")
        phase_bank()
        bank_launches = (kernel.ab_fused.launches, kernel.ns_fused.launches)
        print(f"  launches in bank: ab_fused {bank_launches[0]}, "
              f"ns_fused {bank_launches[1]}")
        # one abnormal detect per scenario, one non-scalable per series
        check(bank_launches == (6, 1), f"bank launches {bank_launches}")
        print(f"[fleet] {FLEET_SCALES[-1]} procs, shards=8, "
              f"scales {FLEET_SCALES}")
        phase_fleet()
        launches = {"ab_fused": kernel.ab_fused.launches,
                    "ns_fused": kernel.ns_fused.launches}
        for n, c in launches.items():
            check(c > 0, f"{n} was never launched on the main path")
        print(f"[kernels] main-path launches (bank + fleet): {launches}")
        t_model = time.perf_counter()
        print(f"[model] {MODELS[0][0]} at full width on the card, {card}")
        err["flash_attention"] = phase_flash()
        timing["flash_attention"] = tm = time_flash()
        print(f"  flash_attention {FLASH_FULL} f32: {tm['ms']:.4f} ms  plain "
              f"{tm['plain_ms']:.4f} ms  bound {tm['bound'][0]:.4f} ms "
              f"({tm['bound'][1]}, 3xTF32; CUDA-core f32 "
              f"{tm['core_bound'][0]:.4f} ms)  sdpa {tm['library_ms']:.4f} ms"
              f"  [{card}]")
        launches["flash_attention"] = \
            drive_model(*MODELS[0])["flash_attention"]
        print(f"[model] phase wall time {time.perf_counter() - t_model:.1f} s")
        torch.cuda.empty_cache()
        t_ssm = time.perf_counter()
        print(f"[ssm] ssd_scan and the h = 80 flash kernel; "
              f"{', '.join(m[0] for m in MODELS[1:])} at full width, {card}")
        err["ssd_scan"] = phase_ssd()
        ssd_times = time_ssd()
        timing["ssd_scan"] = ssd_times[0]
        for tm in ssd_times:
            print(f"  ssd_scan {tm['case']}: {tm['ms']:.4f} ms  plain "
                  f"{tm['plain_ms']:.4f} ms  bound "
                  f"{tm['bound'][0]:.4f} ms ({tm['bound'][1]}, 3xTF32; "
                  f"CUDA-core f32 {tm['core_bound'][0]:.4f} ms)  library "
                  f"null  [{card}]")
        phase_flash80()
        launches["ssd_scan"] = 0
        for spec in MODELS[1:]:
            launches["ssd_scan"] += drive_model(*spec)["ssd_scan"]
            torch.cuda.empty_cache()
        print(f"[ssm] phase wall time {time.perf_counter() - t_ssm:.1f} s")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    replaces = {"ab_fused": "src/repro/kernels/detect_fused/kernel.py:399",
                "ns_fused": "src/repro/kernels/detect_fused/kernel.py:227",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:96",
                "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:81"}
    package = {"ab_fused": "detect_fused", "ns_fused": "detect_fused",
               "flash_attention": "flash_attention", "ssd_scan": "ssd_scan"}
    rows = []
    for n, tm in timing.items():
        rows.append({
            "name": n, "route": "cuda",
            "source": f"src/repro_torch/kernels/{package[n]}/csrc/{n}.cu",
            "replaces": replaces[n], "launches": launches[n],
            "max_abs_err": err[n], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": tm["library_ms"]})
    print(f"[total] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
          "(host clock, build included)")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   decoded token by token;
7. diagnose — the paper's example
   (``examples/diagnose_scaling_loss_torch.py``) at full width: a tinyllama-1.1b train step (random weights from a
   seed, ``remat``, AdamW) traced into a PSG (its four top-level loops
   with trip counts 22, 4, 4, 22) and profiled for four steps at tokens
   (4, 2049), every second step sampled through the traced graph and
   equal to the eager step on the same state; the step times, the
   profiler's overhead and storage, one eager step under the profiler;
   a 64-process replay with +500 ms at process 17 of the first loop,
   ``detect_abnormal`` on the card (one ``ab_fused`` launch) equal to
   numpy's, and the backtrack to the injected root cause; then one
   mamba2-130m train step at (8, 2049) whose loss equals ``train_loss``;
8. monitor — the always-on ``Monitor`` at 65536 processes over 8 hosts,
   every detect through ``ab_fused`` on the card: three ``chaos_run``s
   under the reference chaos smoke's faults (clean, one dead host, an
   aggregator crash after round 2 and a restore from a snapshot), each
   report, abnormal list and path equal to the numpy backend's run; then
   a Monitor on the card and a numpy one fed the same deltas: steady
   cycles in which one host rewrites 16 rows (exactly 16 rows uploaded,
   one ``abnormal`` launch, the report equal to numpy's; poll-to-report
   latency, median of 5, and one cycle under the profiler), a degraded
   cycle with one host stale (the live-row gather of the same kernel),
   one detect on the daemon thread of ``start()``, and a restore whose
   first detect re-pins every row;
9. runs — ``tools_torch/run_store_smoke_torch.py`` with
   ``diff_runs(backend="torch", device="cuda")``: the amdahl scenario at
   512 processes (precision >= 0.8, a clean-vs-clean diff quiet) and a
   65536-process fleet recorded with ``cluster=64`` (>= 100x, the
   regressed cluster holding every culprit), each equal to the numpy
   backend's diff, with the record, cluster, diff and ``fit_slopes``
   times; then the converged Monitor of phase 8 archived into a
   ``RunStore`` and loaded back equal;
10. moe — the flash kernel at the MoE layers (h = 128: moonshot's MHA
   (2, 16/16, 2048) and dbrx's GQA (1, 48/8, 2048)) against its plain
   version, with its time, the plain version's, SDPA's and its bound;
   then moonshot-v1-16b-a3b (16 of 48 layers) and dbrx-132b (2 of 40)
   at their published widths, random f32 weights from a seed: the loss
   through the kernel against the einsum path (one flash launch a layer)
   and against the sort dispatch, and for moonshot two 128-token prompts
   prefilled and greedy-decoded for 16 tokens, twice, with the decode
   step's time beside its floor (every expert's weights read a step);
11. serve — ``ServingEngine`` at full width: tinyllama-1.1b, mamba2-130m,
   zamba2-2.7b and moonshot-v1-16b-a3b (16 layers) serve seeded prompts
   of 16-64 tokens with continuous batching, greedy and sampled; every
   request completes, uid 0 alone equals its batched stream, a second
   engine gives every stream again; tokens/s, latency, the decode step's
   time, the smallest greedy top-2 gap, and one decode step of tinyllama
   and of moonshot under the profiler;
12. zoo — the flash kernel at the zoo's layers against its plain version,
   with its time, the plain version's, SDPA's and its bound: gemma-7b's
   (2, 16/16, 2048, h = 256) causal in float32 and bfloat16,
   seamless-m4t-medium's encoder layer (4, 16/16, 1024, h = 64)
   non-causal, yi-6b's (2, 32/4, 2048) and nemotron-4-15b's (1, 48/8,
   2048) at h = 128; then nemotron-4-15b, gemma-7b, yi-6b, internvl2-2b
   and seamless-m4t-medium at their published widths and depths, random
   f32 weights from a seed: the loss through the kernel against the plain
   path (tokens (2, 2049); internvl2 after 256 random patch embeddings,
   seamless (4, 513) after 1024 random frames), one flash launch per
   self-attention layer (seamless: 12 non-causal in the encoder, 12
   causal in the decoder); one profiled loss of gemma and of seamless;
   each model's 128-token prompts prefilled and greedy-decoded for 16
   tokens, twice; one AdamW train step of internvl2 and of seamless
   through ``make_train_step``, finite and with the plain loss;
13. trainer — ``Trainer`` on tinyllama-1.1b at full width and depth
   (random f32 weights from seed 0, tokens (4, 2049) from the data
   pipeline): six steps with ScalAna on (every second step sampled
   through the traced graph), the step times, the losses, the PSG, the
   storage and the overhead, and the report's abnormal detect on the card
   (one ``ab_fused`` launch) equal to numpy's; then ``python -m
   repro_torch.launch.train --smoke --ckpt-dir ... --report`` for
   tinyllama and mamba2 (one ``ab_fused`` launch each); then 8 smoke
   steps against 4 + 4 across a checkpoint, within 1e-5, in a temporary
   directory that is deleted;
14. scaling — ``repro_torch.launch.scaling_profile`` at scales 1, 2 and 4
   (12 smoke steps, each scale its worker processes: NCCL for one rank,
   Gloo for the ranks that time-share the card; detection in this
   process): every scale's JSON with its ``n_procs``, congruent PSGs,
   exactly one Comm all-reduce of 4 x (parameters + 1) bytes, each
   scale's median step and all-reduce times, ``detect_non_scalable``
   (``ns_fused``) and ``detect_abnormal`` (``ab_fused``) on the card
   equal to numpy's, the non-scalable vertices and a root-cause path.

The detection kernels' launch counts are reset just before phase 3 and
read just after phase 4, again just before phase 7's detect and just
after it, and again just before phase 8 and just after it (the JSON
line's ``ab_fused`` count is the sum); the kernels' counts of each model
path just before its first loss and just after its serving run; the
flash count just before phase 10's models and just after (added to the
JSON line's), every count just before phase 11 and just after (the
engine reaches no kernel, and the phase fails if one is launched), and
the flash count just before phase 12's models and just after (added to
the JSON line's), and the detection counts just before each detect of
phases 13 and 14 and just after (added to the JSON line's).
It exits non-zero, printing no
result, when any check fails, when there is no CUDA card, or when the
port is not next to it.  The last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import os
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
# [moe]: (arch, layers kept of the published depth, loss tokens); every
# width is the published one, the depth is cut to fit one 80 GB card
MOE_MODELS = [("moonshot-v1-16b-a3b", 16, (2, 2049)),
              ("dbrx-132b", 2, (1, 2049))]
MOE_SORT_TOL = 5e-3             # einsum vs sort (tests/test_models_smoke.py)
MOE_DECODE = 16                 # greedy tokens after a 2 x 128 prefill
# the flash kernel at the MoE layers (h = 128): moonshot's MHA, dbrx's GQA
FLASH_MOE = [(2, 16, 16, 2048, 2048, 128, True),
             (1, 48, 8, 2048, 2048, 128, True)]
# [serve]: (arch, layers kept or None, slots, requests, new tokens)
SERVE = [("tinyllama-1.1b", None, 4, 8, 32),
         ("mamba2-130m", None, 4, 8, 32),
         ("zamba2-2.7b", None, 2, 4, 16),
         ("moonshot-v1-16b-a3b", 16, 4, 6, 16)]
SERVE_MAX_SEQ = 256
SERVE_PROMPTS = (16, 64)        # prompt lengths drawn in [16, 64]
SERVE_PROFILED = ("tinyllama-1.1b", "moonshot-v1-16b-a3b")
# [zoo]: (arch, layers kept or None for the published depth, loss tokens);
# every width is the published one; encdec / vlm losses also take
# frontend_len random frame / patch embeddings a row (1024 and 256)
ZOO_MODELS = [("nemotron-4-15b", None, (2, 2049)),
              ("gemma-7b", None, (2, 2049)),
              ("yi-6b", None, (2, 2049)),
              ("internvl2-2b", None, (2, 2049)),
              ("seamless-m4t-medium", None, (4, 513))]
ZOO_DECODE = 16                 # greedy tokens after a 128-token prefill
ZOO_PROFILED = ("gemma-7b", "seamless-m4t-medium")
ZOO_TRAINED = ("internvl2-2b", "seamless-m4t-medium")
FRONTEND_KEY = {"encdec": "frames", "vlm": "patches"}
# the flash kernel at the zoo's layers: gemma-7b's h = 256 (f32, bf16),
# seamless-m4t-medium's non-causal encoder layer, yi-6b's and
# nemotron-4-15b's GQA at h = 128
FLASH_ZOO = [(2, 16, 16, 2048, 2048, 256, True, "float32"),
             (2, 16, 16, 2048, 2048, 256, True, "bfloat16"),
             (4, 16, 16, 1024, 1024, 64, False, "float32"),
             (2, 32, 4, 2048, 2048, 128, True, "float32"),
             (1, 48, 8, 2048, 2048, 128, True, "float32")]


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


def h100():
    """The H100 SXM data-sheet figures, held by the port's
    ``launch/mesh.py`` (importable once ``main`` has found the port)."""
    from repro_torch.launch import mesh
    return mesh


def bound_ms(n_bytes: int, n_ops: int, ops_per_s: float = 0.0):
    """The larger of the bytes over the HBM rate and the operations over
    ``ops_per_s`` (float32 on the CUDA cores by default)."""
    tb = n_bytes / h100().HBM_BANDWIDTH
    to = n_ops / (ops_per_s or h100().PEAK_FLOPS_FP32)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def flash_bound(q, k, v, causal_flops: int):
    """The flash kernel's bound for its design: bytes read and written once
    over the HBM rate; in f32, three TF32 products per f32 product (3xTF32)
    over the dense TF32 rate, in bf16 one product over the bf16 rate.  Also
    the bound of f32 on the CUDA cores."""
    f32 = q.element_size() == 4
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    design = (bound_ms(n_bytes, 3 * causal_flops, h100().PEAK_FLOPS_TF32)
              if f32 else
              bound_ms(n_bytes, causal_flops, h100().PEAK_FLOPS_BF16))
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
    return (bound_ms(n_bytes, 3 * 2 * macs, h100().PEAK_FLOPS_TF32),
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
            # a record_function range (the models' loop scopes) is a
            # device-side annotation, not device work
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
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
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False)):
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


# -- phase 7: the paper's example at full width ---------------------------

# the contracted PSG's top-level loops of a tinyllama-1.1b step at
# S = 2048: the layer scan, the loss-chunk scan (2048 / 512 chunks, no
# remainder), their backwards
DIAG_LOOPS = [("scan:layers", 22), ("scan:loss_chunks", 4),
              ("scan:loss_chunks.grad", 4), ("scan:layers.grad", 22)]
DIAG_PROCS, DIAG_STRAGGLER, DIAG_DELAY = 64, 17, 0.5


def phase_diagnose(card: str) -> int:
    """[diagnose]: ``examples/diagnose_scaling_loss_torch.py`` at full
    width.  A tinyllama-1.1b train step (random f32 weights from seed 0,
    ``remat``, the einsum path) profiled four times at tokens (4, 2049),
    every second step sampled through the traced graph; a 64-process
    replay with +500 ms at process 17 of the first loop; ``ab_fused`` on
    the card against numpy; the backtrack to the injected root cause.
    Then one mamba2-130m step at (8, 2049).  Returns the ``ab_fused``
    launches of the detect."""
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import COMM, backtrack, detect_abnormal, root_causes
    from repro_torch.core.inject import schedule, simulate
    from repro_torch.core.profiler import GraphProfiler
    from repro_torch.kernels.detect_fused import kernel
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, adamw_update, constant
    from repro_torch.training import TrainState, make_train_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def start(arch, shape):
        cfg = get(arch)
        check(cfg.remat and not cfg.use_kernels, f"{arch}: config {cfg}")
        model = build_model(cfg, device=dev)
        params = model.init(model.generator(0))
        state = TrainState(params, adamw_init(params), None,
                           torch.zeros((), dtype=torch.int32, device=dev))
        batch = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                         device=dev, generator=gen)}
        return model, state, batch, make_train_step(model, RunConfig(),
                                                    constant(1e-3))

    model, state, batch, step = start("tinyllama-1.1b", (4, 2049))
    prof = GraphProfiler(step, (state, batch), sample_every=2)
    psg = prof.psg
    loops = [(v.name, v.meta["trip_count"]) for v in psg.vertices
             if v.parent == psg.root and v.kind == "Loop"]
    print(f"  trace {prof.trace_s:.2f} s: PSG {len(prof.psg_full.vertices)} "
          f"vertices ({len(prof.traced.graph_module.graph.nodes)} ATen "
          f"nodes), contracted {len(psg.vertices)}; loops {loops}")
    check(loops == DIAG_LOOPS, f"diagnose: loops {loops}")
    for i in range(4):
        prev = state
        state, met = prof.step(state, batch)
        check(all(np.isfinite(float(v)) for v in met.values()),
              f"diagnose: step {i} metrics {met}")
        if i == 1:          # the first sampled step, eagerly on its state
            _, eager = step(prev, batch)
            for k in ("loss", "grad_norm"):
                a, b = float(met[k]), float(eager[k])
                check(abs(a - b) <= 1e-5 * abs(b),
                      f"diagnose: sampled {k} {a!r} vs eager {b!r}")
            print(f"  sampled step = eager step on its state: loss "
                  f"{float(met['loss'])!r} / {float(eager['loss'])!r}, "
                  f"grad norm {a!r} / {b!r}")
            del eager
        del prev
    times = prof.step_times
    oh = prof.overhead_estimate()
    print(f"  steps (host clock, synchronised): fast "
          f"{[round(t, 4) for t in times[0::2]]} s, sampled "
          f"{[round(t, 4) for t in times[1::2]]} s; overhead "
          f"{oh['overhead_frac']:.4f} (base {oh['base_step_s']:.4f} s, "
          f"sampled {oh['sampled_step_s']:.4f} s)  [{card}]")
    print(f"  storage {prof.storage_bytes()} B vs full trace "
          f"{prof.full_trace_bytes()} B")
    perf = prof.perf_vectors()
    tops = psg.children(psg.root)
    check(all(v in perf and perf[v].samples == 2 and perf[v].time >= 0
              for v in tops), "diagnose: a top-level vertex has no time")
    print("  per vertex (mean of 2 sampled steps): " + ", ".join(
        f"v{v} {psg.vertices[v].name} {1e3 * perf[v].time:.2f} ms"
        for v in tops) + f"  [{card}]")
    profile_cycle(lambda: step(state, batch)[1]["loss"],
                  what="eager tinyllama-1.1b step")
    del model, step

    # the gradient all-reduce every DP step executes, as in the example
    ar = psg.new_vertex(COMM, "psum(grads)", parent=psg.root,
                        source="src/repro_torch/optim/adamw.py:"
                        f"{adamw_update.__code__.co_firstlineno}")
    ar.comm_kind, ar.comm_bytes = "all_reduce", 8e6
    psg.add_edge(tops[-1], ar.vid, "data")
    psg.add_edge(psg.root, ar.vid, "control")
    target = next(v for v in schedule(psg) if psg.vertices[v].kind == "Loop")
    check(psg.vertices[target].name == "scan:layers",
          f"diagnose: first loop {psg.vertices[target].name}")
    res = simulate(psg, DIAG_PROCS, prof.base_times(),
                   inject={(DIAG_STRAGGLER, target): DIAG_DELAY})
    del prof
    kernel.reset_launches()
    t0 = time.perf_counter()
    ab = detect_abnormal(res.ppg, abnorm_thd=1.3, backend="torch", device=dev)
    secs = time.perf_counter() - t0
    launches = kernel.ab_fused.launches
    check((launches, kernel.ns_fused.launches) == (1, 0),
          f"diagnose: launches ab_fused {launches}, "
          f"ns_fused {kernel.ns_fused.launches}")
    want = detect_abnormal(res.ppg, abnorm_thd=1.3, backend="numpy")
    check([(a.vid, a.proc, a.time, a.typical) for a in ab]
          == [(a.vid, a.proc, a.time, a.typical) for a in want],
          "diagnose: abnormal differs from numpy")
    paths = backtrack(res.ppg, [], ab)
    hit = any(node == (DIAG_STRAGGLER, target)
              for node, _, _ in root_causes(paths, psg, ppg=res.ppg))
    print(f"  injected +{1e3 * DIAG_DELAY:.0f} ms at p{DIAG_STRAGGLER} v"
          f"{target} ({psg.vertices[target].source}); detect "
          f"{1e3 * secs:.2f} ms, {len(ab)} abnormal = numpy's; "
          f"ab_fused launches {launches}")
    print(f"  root cause recovered: {hit}")
    check(hit, "diagnose: the injected straggler was not recovered")
    del state, batch
    torch.cuda.empty_cache()

    # the SSM family's backward on the card
    model, state, batch, step = start("mamba2-130m", (8, 2049))
    with torch.no_grad():
        want = float(model.train_loss(state.params, batch)[0])
    step(state, batch)                        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, met = step(state, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, gnorm = float(met["loss"]), float(met["grad_norm"])
    check(abs(got - want) <= 1e-6 * abs(want),
          f"diagnose: mamba2 step loss {got!r} vs train_loss {want!r}")
    check(np.isfinite(gnorm), f"diagnose: mamba2 grad norm {gnorm}")
    print(f"  mamba2-130m step (8, 2049): {secs:.4f} s, loss {got:.6f} = "
          f"train_loss, grad norm {gnorm:.4f}  [{card}]")
    del model, state, batch, step, new
    torch.cuda.empty_cache()
    return launches

# -- phase 8: the always-on Monitor at fleet scale ------------------------

MON_PROCS, MON_HOSTS, MON_ROWS = 65536, 8, 16
CHAOS_RUNS = [("clean", dict(seed=0)),
              ("one dead host", dict(seed=1, dead_hosts=(2,))),
              ("crash after round 2 + restore",
               dict(seed=2, crash_after_round=2))]


def phase_monitor(card: str):
    """[monitor]: the port's always-on Monitor at 65536 processes over 8
    hosts, every detect on the card.  Three ``chaos_run``s under the
    reference smoke's faults (clean, one dead host, a crash and a restore
    from a snapshot), each equal to the numpy backend's run; then a pair
    of Monitors (card, numpy) fed the same deltas: steady cycles that
    rewrite 16 rows of one host (exactly 16 rows uploaded, one
    ``abnormal`` launch), one under the profiler, a degraded cycle (one
    host stale: the live-row gather), one detect on the daemon thread of
    ``start()``, and a restore whose first detect re-pins every row.
    Returns the card's Monitor (converged) for ``[runs]``."""
    import tempfile
    import threading
    import numpy as np
    from repro_torch.core.inject import simulate
    from repro_torch.core.shard import ShardedStore, shard_ranges
    from repro_torch.kernels.detect_fused import kernel, ops
    from repro_torch.monitor import (Monitor, QueueTransport, ShardProducer,
                                     build_chaos_psg, chaos_run)
    sys.path.insert(0, str(ROOT))
    # the reference chaos smoke's fault mix, what must agree, and a
    # transport feeding two Monitors
    from tools_torch.chaos_smoke_torch import FAULTS, Tee, report_key

    for name, kw in CHAOS_RUNS:
        res, secs = {}, {}
        for backend, dev in (("torch", "cuda"), ("numpy", None)):
            with tempfile.TemporaryDirectory() as d:
                snap = {"snapshot_dir": d} if "crash_after_round" in kw \
                    else {}
                t0 = time.perf_counter()
                res[backend] = chaos_run(
                    n_procs=MON_PROCS, n_hosts=MON_HOSTS, backend=backend,
                    device=dev, **FAULTS, **kw, **snap)
                secs[backend] = time.perf_counter() - t0
        got = res["torch"]
        check(got.converged, f"monitor chaos {name}: did not converge "
              f"(abnormal {got.abnormal_match}, paths {got.paths_match})")
        check(report_key(got.report) == report_key(res["numpy"].report),
              f"monitor chaos {name}: report differs from numpy")
        check(got.report.degraded == ("dead_hosts" in kw),
              f"monitor chaos {name}: degraded {got.report.degraded}")
        print(f"  chaos {name}: converged = numpy; {got.deltas_applied} "
              f"deltas applied, {got.duplicates_absorbed} duplicates "
              f"absorbed, {len(got.report.abnormal)} abnormal; "
              f"{got.report.coverage}; {secs['torch']:.2f} s (numpy "
              f"{secs['numpy']:.2f} s, host clock)")

    # -- a pair of Monitors fed the same deltas ----------------------------
    psg = build_chaos_psg()
    V = len(psg.vertices)
    ranges = shard_ranges(MON_PROCS, MON_HOSTS)
    rng = np.random.default_rng(0)
    straggler = int(rng.integers(MON_PROCS))
    slow_vid = int(rng.integers(1, V - 1))
    truth = simulate(psg, MON_PROCS,
                     lambda p, v: 0.0 if psg.vertices[v].kind == "Comm"
                     else 1.0 + 0.01 * v,
                     inject={(straggler, slow_vid): 4.0},
                     comm_time=lambda *a: 0.05, jitter=0.0, seed=0,
                     shards=ranges).ppg
    now = [0.0]
    clock = lambda: now[0]                                # noqa: E731
    snapdir = tempfile.TemporaryDirectory()
    q_card, q_host = QueueTransport(), QueueTransport()
    kw = dict(comm=truth.comm, detect_every=1, stale_after=2.5, clock=clock)
    # snapshots only when asked for (the restore below), so that no
    # cycle's time includes a periodic snapshot
    mon = Monitor(psg, ranges, q_card, backend="torch", device="cuda",
                  snapshot_dir=snapdir.name, snapshot_every=1 << 30, **kw)
    ref = Monitor(psg, ranges, q_host, backend="numpy", **kw)
    prod = ShardedStore(ranges, V)
    producers = [ShardProducer(h, prod.shards[h], Tee(q_card, q_host),
                               clock=clock, sleep=lambda s: None)
                 for h in range(MON_HOSTS)]
    for h, p in enumerate(producers):
        sh = prod.shards[h]
        sh.apply_rows(truth.perf.shards[h].extract_rows(
            np.arange(sh.n_procs)))
        p.flush()
    first = mon.poll()
    check(first is not None and report_key(first)
          == report_key(ref.poll()), "monitor: first detect differs")
    view = mon.ppg.device_view(mon.device)
    check((view.full_uploads, view.last_upload_rows) == (1, MON_PROCS),
          f"monitor: first detect uploaded {view.last_upload_rows} rows in "
          f"{view.full_uploads} full uploads")

    def rewrite(h: int, stall: float) -> None:
        sh = prod.shards[h]
        rows = np.sort(rng.choice(sh.n_procs, MON_ROWS, replace=False))
        sh.set_entries(rows, slow_vid, stall)
        producers[h].flush()

    def cycle(tag: str, h: int, stall: float, degraded: bool = False):
        rewrite(h, stall)
        ops.reset_launch_counts()
        before = kernel.ab_fused.launches
        t0 = time.perf_counter()
        rep = mon.poll()
        ms = (time.perf_counter() - t0) * 1e3
        check(rep is not None, f"monitor {tag}: poll produced no report")
        check(view.last_upload_rows == MON_ROWS,
              f"monitor {tag}: uploaded {view.last_upload_rows} rows")
        check(dict(ops.launch_counts) == {"abnormal": 1}
              and kernel.ab_fused.launches == before + 1,
              f"monitor {tag}: launches {dict(ops.launch_counts)}, "
              f"ab_fused {kernel.ab_fused.launches - before}")
        check(rep.degraded == degraded,
              f"monitor {tag}: degraded {rep.degraded}")
        check(report_key(rep) == report_key(ref.poll()),
              f"monitor {tag}: report differs from numpy's")
        return ms

    cycles = [cycle("steady cycle", i % MON_HOSTS, 5.0 + i)
              for i in range(6)][1:]
    print(f"  steady cycle: host h rewrites {MON_ROWS} rows and flushes, "
          f"poll() detects: {MON_ROWS} rows uploaded, launches "
          f"{{'abnormal': 1}}, report = numpy's; poll to report "
          f"{statistics.median(cycles):.3f} ms (median of 5, host clock; "
          f"{', '.join(f'{c:.3f}' for c in cycles)})  [{card}]")
    rewrite(6, 11.5)
    rep = profile_cycle(mon.poll, what="Monitor steady cycle (poll)")
    check(rep is not None and report_key(rep) == report_key(ref.poll()),
          "monitor: profiled cycle differs from numpy's")

    # one host stale: the live-row gather of the same kernel
    now[0] += 5.0
    for h, p in enumerate(producers):
        if h != 3:
            p.send_heartbeat()
    ms = cycle("degraded cycle", 0, 12.5, degraded=True)
    print(f"  degraded cycle (h3 stale, {MON_PROCS - MON_PROCS // MON_HOSTS}"
          f" live rows gathered on the card): = numpy's, one abnormal "
          f"launch, {ms:.3f} ms  [{card}]")
    producers[3].send_heartbeat()

    # one detect on the daemon thread
    done, errors = threading.Event(), []
    hook = threading.excepthook
    threading.excepthook = errors.append
    mon.on_report = lambda r: done.set()
    ops.reset_launch_counts()
    mon.start(poll_interval=0.005)
    try:
        rewrite(1, 13.5)
        streamed = done.wait(timeout=120)
    finally:
        mon.stop()
        threading.excepthook = hook
        mon.on_report = None
    check(not errors, f"monitor thread raised: {errors and errors[0]}")
    check(streamed, "monitor thread produced no report")
    check(dict(ops.launch_counts) == {"abnormal": 1},
          f"monitor thread launches {dict(ops.launch_counts)}")
    check(report_key(mon.reports[-1]) == report_key(ref.poll()),
          "monitor thread: report differs from numpy's")
    print("  start()/stop(): one detect on the daemon thread, one abnormal "
          "launch, report = numpy's")

    # crash + restore: the first detect re-pins every row
    mon.snapshot()
    back = Monitor.restore(psg, QueueTransport(), snapdir.name,
                           backend="torch", device="cuda", **kw)
    rep = back.force_detect()
    again = back.ppg.device_view(back.device)
    check((again.full_uploads, again.last_upload_rows) == (1, MON_PROCS),
          f"monitor restore: {again.last_upload_rows} rows in "
          f"{again.full_uploads} full uploads")
    check(report_key(rep) == report_key(ref.force_detect()),
          "monitor restore: report differs from numpy's")
    print(f"  restore from a snapshot: the first detect re-pins all "
          f"{MON_PROCS} rows (one full upload), report = numpy's")
    snapdir.cleanup()
    return mon


# -- phase 9: the run store -------------------------------------------------

def phase_runs(card: str, mon) -> None:
    """[runs]: ``tools_torch/run_store_smoke_torch.py`` on the card (part
    A: the amdahl scenario at 512 processes; part B: a 65536-process
    fleet recorded with ``cluster=64``), each diff equal to the numpy
    backend's; then the converged Monitor of ``[monitor]`` archived into
    a ``RunStore`` and loaded back equal."""
    import tempfile
    import numpy as np
    sys.path.insert(0, str(ROOT))
    from tools_torch import run_store_smoke_torch as rs
    from repro_torch.runs import RunStore

    a = rs.part_a("cuda")
    print(f"  {a['line']}  [{card}]")
    check(a["ok"], "runs: part A failed")
    b = rs.part_b("cuda")
    print(f"  {b['line']}  [{card}]")
    check(b["ok"], "runs: part B failed")
    last = mon.reports[-1]
    with tempfile.TemporaryDirectory() as d:
        store = RunStore(d)
        t0 = time.perf_counter()
        rec = store.load(mon.archive_to(store, meta={"label": "monitor"}))
        secs = time.perf_counter() - t0
    V = len(mon.psg.vertices)
    check(rec.scale == MON_PROCS and rec.meta["label"] == "monitor",
          f"runs: archived scale {rec.scale}, meta {rec.meta}")
    check(np.array_equal(np.asarray(rec.ppg.times_matrix()),
                         np.asarray(mon.store.time_matrix(V))),
          "runs: the archived fleet's times differ from the Monitor's")
    check(rec.psg.to_json() == mon.psg.to_json(),
          "runs: the archived PSG differs")
    check([(x.vid, x.proc, x.time, x.typical) for x in rec.detect["abnormal"]]
          == [(x.vid, x.proc, x.time, x.typical) for x in last.abnormal],
          "runs: the archived abnormal list differs from the report's")
    print(f"  Monitor.archive_to: {MON_PROCS} procs recorded and loaded "
          f"back equal (times, PSG, {len(last.abnormal)} abnormal) in "
          f"{secs:.2f} s")


# -- phase 10: the MoE family ------------------------------------------------

def flash_layers(cases, card: str):
    """The flash kernel at model layers ``(B, nq, nkv, Sq, Sk, h, causal,
    dtype name)`` against its plain version within ``FLASH_TOL``; its time,
    the plain version's, SDPA's and the bound, a line each.  A causal
    call's bound counts the lower triangle, 2 B nq S^2 h operations; a
    full one both products over the whole square, 4 B nq Sq Sk h.
    Returns the rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref

    rows = []
    for case in cases:
        B, nq, nkv, Sq, Sk, h, causal, dt = case
        scale = h ** -0.5
        q, k, v = flash_inputs(case, seed=nq)
        got = kernel.flash_attention(q, k, v, causal=causal,
                                     softmax_scale=scale)
        want = ref.attention(q, k, v, causal=causal, softmax_scale=scale)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        tol = FLASH_TOL[dt]
        check(bool((d <= tol + tol * want.float().abs()).all())
              and bool(torch.isfinite(got).all()),
              f"flash {case}: max abs err {d.max().item():.3g}")
        flops = (2 if causal else 4) * B * nq * Sq * Sk * h
        bound, core = flash_bound(q, k, v, flops)
        row = dict(
            case=case, max_abs_err=d.max().item(),
            ms=cuda_ms(lambda: kernel.flash_attention(
                q, k, v, causal=causal, softmax_scale=scale)),
            plain_ms=cuda_ms(lambda: ref.attention(
                q, k, v, causal=causal, softmax_scale=scale), reps=10),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale,
                enable_gqa=nq != nkv)),
            bound=bound, core_bound=core)
        rows.append(row)
        design = "3xTF32" if dt == "float32" else "bf16"
        print(f"  flash_attention {case}: {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  bound {bound[0]:.4f} ms "
              f"({bound[1]}, {design}; CUDA-core f32 {core[0]:.4f} ms)  sdpa "
              f"{row['library_ms']:.4f} ms  max abs err "
              f"{row['max_abs_err']:.3g} within {tol}  [{card}]")
        del q, k, v, got, want, d
    torch.cuda.empty_cache()
    return rows


def phase_moe(card: str) -> int:
    """[moe]: each MoE model at its published widths, cut in depth, random
    f32 weights from seed 0.  The loss through the flash kernel against
    the einsum path (within 1e-3, one flash launch a layer) and against
    the sort dispatch (within ``MOE_SORT_TOL``); for moonshot, two
    128-token prompts prefilled into a 256-token cache and decoded
    greedily for ``MOE_DECODE`` tokens, twice.  Returns the flash
    launches the phase must have made."""
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import build_model

    want = 0
    for arch, layers, shape in MOE_MODELS:
        cfg = get(arch).replace(n_layers=layers)
        plain = build_model(cfg)
        t0 = time.perf_counter()
        params = plain.init(plain.generator(0))
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"  {arch} ({layers} of {get(arch).n_layers} layers) init: "
              f"{plain.param_count()} params, {n_bytes / 1e9:.2f} GB on the "
              f"card, {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, shape, dtype=np.int64)).to("cuda")}
        losses = {}
        for name, model in (
                ("kernel", build_model(cfg.replace(use_kernels=True))),
                ("einsum", plain),
                ("sort", build_model(cfg, moe_strategy="sort"))):
            before = flash.flash_attention.launches
            t0 = time.perf_counter()
            loss, met = model.train_loss(params, batch)
            losses[name] = (float(loss), float(met["moe_drop_frac"]),
                            time.perf_counter() - t0)
            made = flash.flash_attention.launches - before
            check(made == (layers if name == "kernel" else 0),
                  f"{arch} {name} loss: {made} flash launches")
            check(np.isfinite(losses[name][0]), f"{arch} {name} loss "
                  f"{losses[name][0]}")
            del loss, met
        want += layers
        lk, l0, ls = (losses[n][0] for n in ("kernel", "einsum", "sort"))
        check(abs(lk - l0) < 1e-3, f"{arch}: kernel loss {lk!r} vs einsum "
              f"{l0!r}")
        check(abs(ls - l0) < MOE_SORT_TOL, f"{arch}: sort loss {ls!r} vs "
              f"einsum {l0!r}")
        # moe_drop_frac is summed over the layers, as in the reference
        print(f"  {arch} train_loss tokens {shape}: " + ", ".join(
            f"{n} {v[0]!r} (drop {v[1] / layers:.6f} a layer, {v[2]:.3f} s)"
            for n, v in losses.items())
            + f"; |kernel - einsum| {abs(lk - l0):.3g}, |sort - einsum| "
            f"{abs(ls - l0):.3g}; {layers} flash launches (host clock, "
            f"first calls)  [{card}]")
        if arch == MOE_MODELS[0][0]:
            prompts = batch["tokens"][:, :PROMPT].contiguous()

            def serve():
                steps = []
                with torch.no_grad():
                    logits, cache = plain.prefill(params, {"tokens": prompts},
                                                  MAX_LEN)
                    out = []
                    for _ in range(MOE_DECODE):
                        tok = logits[:, -1].argmax(-1, keepdim=True)
                        out.append(tok)
                        t0 = time.perf_counter()
                        logits, cache = plain.decode_step(params, cache, tok)
                        torch.cuda.synchronize()
                        steps.append((time.perf_counter() - t0) * 1e3)
                check(int(cache.kv.length[0]) == PROMPT + MOE_DECODE,
                      f"{arch}: cache length")
                return torch.cat(out, 1), steps

            toks_a, steps = serve()
            toks_b, _ = serve()
            check(torch.equal(toks_a, toks_b), f"{arch}: greedy decode is "
                  "not deterministic")
            expert = cfg.n_experts * cfg.d_model * cfg.d_ff * 3 * 4 * layers
            floor = expert / h100().HBM_BANDWIDTH * 1e3
            print(f"  {arch} prefill 2 x {PROMPT} into {MAX_LEN}, "
                  f"{MOE_DECODE} greedy tokens twice: identical; decode step "
                  f"{statistics.median(steps):.3f} ms (median of "
                  f"{MOE_DECODE}, host clock), floor {floor:.3f} ms "
                  f"({expert / 1e9:.1f} GB of expert weights read a step)  "
                  f"[{card}]")
        del params, plain, batch
        torch.cuda.empty_cache()
    return want


# -- phase 11: the serving engine ---------------------------------------------

def phase_serve(card: str) -> None:
    """[serve]: ``ServingEngine`` at full width on the card for each model
    of ``SERVE``: seeded prompts of 16-64 tokens, even uids greedy, odd
    uids at temperature 0.8 with ``seed = uid``.  Every uid completes with
    its token count; uid 0 alone (one slot) gives its batched stream; a
    second engine on the same weights gives every uid's tokens and the
    same number of decode steps; no slot's position passes max_seq - 1.
    One decode step of each of ``SERVE_PROFILED`` under the profiler."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    class Timed(ServingEngine):
        """The engine, each decode step timed (host clock, synchronised),
        the smallest top-2 logit gap of its greedy picks and the largest
        position it decoded at recorded."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.step_ms, self.min_gap, self.max_pos = [], math.inf, 0

        def _step_model(self, tok_batch):
            self.max_pos = max(self.max_pos, int(self.slot_pos.max()))
            t0 = time.perf_counter()
            out = super()._step_model(tok_batch)
            torch.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def _sample(self, slot, logits, position):
            if self.slot_req[slot].temperature <= 0.0:
                top = np.partition(logits[slot], -2)[-2:]
                self.min_gap = min(self.min_gap, float(top[1] - top[0]))
            return super()._sample(slot, logits, position)

    for arch, layers, slots, n_req, new in SERVE:
        cfg = get(arch)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        model = build_model(cfg)
        params = model.init(model.generator(0))
        rng = np.random.default_rng(0)
        lens = rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, n_req)

        def requests():
            prompts = np.random.default_rng(1)
            return [Request(uid=i, prompt=prompts.integers(
                        1, cfg.vocab_size, int(lens[i])),
                        max_new_tokens=new, seed=i,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                    for i in range(n_req)]

        runs = []
        for _ in range(2):
            eng = Timed(model, params, batch_slots=slots,
                        max_seq=SERVE_MAX_SEQ)
            t0 = time.perf_counter()
            res = eng.run(requests())
            runs.append((eng, res, time.perf_counter() - t0))
        (eng, res, wall), (eng_b, res_b, _) = runs
        check([r.uid for r in res] == list(range(n_req))
              and all(len(r.tokens) == new for r in res),
              f"serve {arch}: token counts "
              f"{[(r.uid, len(r.tokens)) for r in res]}")
        check([r.tokens for r in res] == [r.tokens for r in res_b],
              f"serve {arch}: a second engine gave other tokens")
        check(eng.decode_steps == eng_b.decode_steps,
              f"serve {arch}: decode steps {eng.decode_steps} vs "
              f"{eng_b.decode_steps}")
        check(max(eng.max_pos, eng_b.max_pos) <= SERVE_MAX_SEQ - 1,
              f"serve {arch}: position {eng.max_pos}")
        alone = Timed(model, params, batch_slots=1, max_seq=SERVE_MAX_SEQ)
        solo = alone.run(requests()[:1])[0].tokens
        check(solo == res[0].tokens, f"serve {arch}: uid 0 alone "
              f"{solo} vs batched {res[0].tokens}")
        toks = sum(len(r.tokens) for r in res)
        lat = [r.latency_s * 1e3 for r in res]
        gap = min(e.min_gap for e in (eng, eng_b, alone))
        print(f"  {arch}{'' if layers is None else f' ({layers} layers)'}: "
              f"{n_req} requests (prompts {lens.tolist()}), {slots} slots, "
              f"max_seq {SERVE_MAX_SEQ}: {toks} tokens in {wall:.2f} s "
              f"({toks / wall:.1f} tok/s); latency p50 "
              f"{np.percentile(lat, 50):.1f} ms, p99 "
              f"{np.percentile(lat, 99):.1f} ms; {eng.decode_steps} decode "
              f"steps, median {statistics.median(eng.step_ms):.3f} ms (host "
              f"clock); uid 0 alone = batched; second engine identical; "
              f"smallest greedy top-2 gap {gap:.3g} (tie tol 1e-4)  [{card}]")
        if arch in SERVE_PROFILED:
            idle = np.zeros((slots, 1), np.int32)
            profile_cycle(lambda: eng_b._step_model(idle)[0],
                          f"{arch} decode step ({slots} slots)")
        del runs, eng, eng_b, alone, model, params
        torch.cuda.empty_cache()


# -- phase 12: the rest of the model zoo ------------------------------------

def zoo_batch(cfg, shape, device, seed: int = 0):
    """Seeded tokens of ``shape`` and, for encdec / vlm, ``frontend_len``
    random N(0, 1) frame or patch embeddings a row, on ``device``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape, dtype=np.int64)).to(device)}
    key = FRONTEND_KEY.get(cfg.family)
    if key:
        gen = torch.Generator(device=device).manual_seed(seed)
        batch[key] = torch.randn((shape[0], cfg.frontend_len, cfg.d_model),
                                 generator=gen, device=device)
    return batch


def phase_zoo(card: str) -> int:
    """[zoo]: each of ``ZOO_MODELS`` at its published widths, random f32
    weights from seed 0: the loss through the flash kernel against the
    plain path (within 1e-3, one flash launch per self-attention layer:
    the decoder's, and for seamless the encoder's too, non-causal); for
    ``ZOO_PROFILED`` one more kernel loss under the profiler; 2-4 prompts
    of 128 tokens (after the frames or patches) prefilled and decoded
    greedily for ``ZOO_DECODE`` tokens, twice; for ``ZOO_TRAINED`` one
    AdamW train step through ``make_train_step`` (the plain path: the
    kernel has no backward), finite and with the plain loss.  Returns the
    flash launches the phase must have made."""
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, constant
    from repro_torch.training import TrainState, make_train_step

    want = 0
    for arch, layers, shape in ZOO_MODELS:
        cfg = get(arch) if layers is None else \
            get(arch).replace(n_layers=layers)
        depth = "" if layers is None else \
            f" ({layers} of {get(arch).n_layers} layers)"
        plain = build_model(cfg)
        kern = build_model(cfg.replace(use_kernels=True))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = plain.init(plain.generator(0))
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"  {arch}{depth} init: {plain.param_count()} params, "
              f"{n_bytes / 1e9:.2f} GB on the card, "
              f"{time.perf_counter() - t0:.1f} s")
        batch = zoo_batch(cfg, shape, plain.device)
        per_loss = cfg.n_layers + (cfg.enc_layers
                                   if cfg.family == "encdec" else 0)
        secs = {}
        with torch.no_grad():
            before = flash.flash_attention.launches
            t0 = time.perf_counter()
            lk = float(kern.train_loss(params, batch)[0])
            secs["kernel"] = time.perf_counter() - t0
            made = flash.flash_attention.launches - before
            t0 = time.perf_counter()
            l0 = float(plain.train_loss(params, batch)[0])
            secs["plain"] = time.perf_counter() - t0
        want += per_loss
        check(np.isfinite(lk) and np.isfinite(l0),
              f"{arch} loss: kernel {lk}, plain {l0}")
        check(made == per_loss, f"{arch} loss: {made} flash launches, "
              f"expected {per_loss}")
        check(abs(lk - l0) < 1e-3, f"{arch}: kernel loss {lk!r} vs plain "
              f"{l0!r}")
        front = {k: tuple(v.shape) for k, v in batch.items()
                 if k != "tokens"}
        print(f"  {arch} train_loss tokens {shape}"
              + (f", {front}" if front else "")
              + f": kernel {lk!r} ({secs['kernel']:.3f} s), plain {l0!r} "
              f"({secs['plain']:.3f} s; host clock, first calls); |diff| "
              f"{abs(lk - l0):.3g}; {made} flash launches  [{card}]")
        if arch in ZOO_PROFILED:
            with torch.no_grad():
                got = profile_cycle(
                    lambda: kern.train_loss(params, batch)[0],
                    f"{arch} train_loss {shape}",
                    share=("flash_", "tf32_planes"))
            want += per_loss
            check(abs(float(got) - l0) < 1e-3,
                  f"{arch}: the profiled loss {float(got)!r} vs {l0!r}")

        prompts = {k: v[:, :PROMPT].contiguous() if k == "tokens" else v
                   for k, v in batch.items()}
        prefix = cfg.frontend_len if cfg.family == "vlm" else 0

        def serve():
            steps = []
            with torch.no_grad():
                logits, cache = plain.prefill(params, prompts,
                                              prefix + MAX_LEN)
                check(bool(torch.isfinite(logits).all()),
                      f"{arch}: prefill logits not finite")
                out = []
                for _ in range(ZOO_DECODE):
                    tok = logits[:, -1].argmax(-1, keepdim=True)
                    out.append(tok)
                    t0 = time.perf_counter()
                    logits, cache = plain.decode_step(params, cache, tok)
                    torch.cuda.synchronize()
                    steps.append((time.perf_counter() - t0) * 1e3)
            kv = cache.self_kv if cfg.family == "encdec" else cache.kv
            check(int(kv.length[0]) == prefix + PROMPT + ZOO_DECODE,
                  f"{arch}: cache length {int(kv.length[0])}")
            return torch.cat(out, 1), steps

        toks_a, steps = serve()
        toks_b, _ = serve()
        check(torch.equal(toks_a, toks_b), f"{arch}: greedy decode is not "
              "deterministic")
        print(f"  {arch} prefill {shape[0]} x {PROMPT}"
              + (f" after {prefix} patches" if prefix else "")
              + f" into {prefix + MAX_LEN}, {ZOO_DECODE} greedy tokens "
              f"twice: identical; decode step "
              f"{statistics.median(steps):.3f} ms (median of {ZOO_DECODE}, "
              f"host clock)  [{card}]")

        if arch in ZOO_TRAINED:
            step = make_train_step(plain, RunConfig(), constant(1e-3))
            state = TrainState(params, adamw_init(params), None,
                               torch.zeros((), dtype=torch.int32,
                                           device=plain.device))
            t0 = time.perf_counter()
            new, met = step(state, batch)
            torch.cuda.synchronize()
            t_step = time.perf_counter() - t0
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            check(np.isfinite(loss) and np.isfinite(gnorm)
                  and all(bool(torch.isfinite(t).all())
                          for t in _leaves(new.params)),
                  f"{arch} train step: loss {loss}, grad norm {gnorm}")
            check(abs(loss - l0) <= 1e-5 * abs(l0),
                  f"{arch} train step loss {loss!r} vs train_loss {l0!r}")
            print(f"  {arch} AdamW train step (remat, no kernel) tokens "
                  f"{shape}: loss {loss!r} (= train_loss), grad norm "
                  f"{gnorm:.6g}, {t_step:.3f} s (host clock, first call)  "
                  f"[{card}]")
            del step, state, new, met
        print(f"  {arch} peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del params, plain, kern, batch, prompts
        torch.cuda.empty_cache()
    return want


# -- phase 13: the Trainer, the launcher and resume ------------------------

TRAIN_ARCH, TRAIN_SHAPE, TRAIN_STEPS = "tinyllama-1.1b", (2048, 4), 6
CLI_ARCHS = ("tinyllama-1.1b", "mamba2-130m")
RESUME_TOL = 1e-5                 # tests/test_elastic.py:29-49


def phase_trainer(card: str) -> int:
    """[trainer]: ``Trainer`` on tinyllama-1.1b at full width and depth
    (random f32 weights from seed 0, tokens (4, 2049) from the data
    pipeline), six steps with ScalAna on (every second step sampled); the
    measured times replayed over 64 processes with the first loop twice
    as slow at one of them, and the report's abnormal detect on that PPG
    on the card equal to numpy's and naming the slowed loop; then
    ``python -m repro_torch.launch.train --smoke`` for two families with
    a checkpoint directory and ``--report`` (one process: its detect
    launches ``ab_fused`` but can flag nothing, so only the launch is
    checked); then 8 smoke steps against 4 + 4 across a checkpoint.
    Returns the ``ab_fused`` launches of the detects."""
    import contextlib
    import io
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get, get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core import backtrack, detect_abnormal, render_report
    from repro_torch.core.inject import schedule, simulate
    from repro_torch.kernels.detect_fused import kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.training import Trainer

    run = RunConfig(arch=TRAIN_ARCH, total_steps=TRAIN_STEPS,
                    warmup_steps=1, learning_rate=1e-4, scalana=True,
                    scalana_sample_every=2)
    cfg = get(TRAIN_ARCH)
    tr = Trainer(run, arch_cfg=cfg,
                 shape=ShapeConfig("card", *TRAIN_SHAPE, "train"))
    check(tr.device.type == "cuda", f"trainer: device {tr.device}")
    t0 = time.perf_counter()
    tr.train(num_steps=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in tr.metrics_log if "loss" in m]
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
          f"trainer: losses {losses}")
    prof = tr.profiler
    psg, perf, storage = tr.scalana_artifacts()
    oh = prof.overhead_estimate()
    print(f"  {TRAIN_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{tr.model.param_count()} params), tokens "
          f"{tr.dataset.local_batch} x {TRAIN_SHAPE[0] + 1}: {TRAIN_STEPS} "
          f"steps in {wall:.1f} s (trace {prof.trace_s:.2f} s); loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}  [{card}]")
    print(f"  steps (host clock, synchronised): "
          f"{[round(t, 4) for t in tr.step_wall_times]} s; overhead_frac "
          f"{oh['overhead_frac']:.4f} (base {oh['base_step_s']:.4f} s, "
          f"sampled {oh['sampled_step_s']:.4f} s); PSG {psg.stats()}; "
          f"storage {storage} B vs full trace {prof.full_trace_bytes()} B")
    check(prof.sampled_steps == TRAIN_STEPS // 2,
          f"trainer: {prof.sampled_steps} sampled steps")
    # one process cannot be abnormal (a time above 1.3x the median over
    # processes): replay the measured times over DIAG_PROCS processes,
    # the first loop twice as slow at DIAG_STRAGGLER
    target = next(v for v in schedule(psg) if psg.vertices[v].kind == "Loop")
    ppg = simulate(psg, DIAG_PROCS, prof.base_times(),
                   inject={(DIAG_STRAGGLER, target): perf[target].time}).ppg
    del tr, prof
    torch.cuda.empty_cache()
    kernel.reset_launches()
    ab = detect_abnormal(ppg, abnorm_thd=run.abnorm_thd, backend="torch",
                         device="cuda")
    launches = kernel.ab_fused.launches
    check(launches == 1, f"trainer: ab_fused launches {launches}")
    check(ab == detect_abnormal(ppg, abnorm_thd=run.abnorm_thd,
                                backend="numpy"),
          "trainer: abnormal differs from numpy")
    check(any((a.proc, a.vid) == (DIAG_STRAGGLER, target) for a in ab),
          f"trainer: the slowed loop is not flagged: "
          f"{[(a.proc, a.vid) for a in ab]}")
    report = render_report(ppg, [], ab, backtrack(ppg, [], ab))
    check("scaling-loss report" in report, "trainer: no report")
    print(f"  report over {DIAG_PROCS} replayed processes, v{target} "
          f"{psg.vertices[target].name} twice as slow at p{DIAG_STRAGGLER}: "
          f"{len(ab)} abnormal = numpy's, the slowed loop among them; "
          f"ab_fused launches {launches}, {len(report.splitlines())} lines")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        for arch in CLI_ARCHS:
            ckpt = f"{tmp}/{arch}"
            out = io.StringIO()
            kernel.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                launch_train.main(["--arch", arch, "--smoke", "--steps", "6",
                                   "--sample-every", "2", "--ckpt-dir", ckpt,
                                   "--report"])
            secs = time.perf_counter() - t0
            text = out.getvalue()
            check(f"[train] {arch} (smoke) on cuda" in text
                  and "scaling-loss report" in text,
                  f"trainer: launcher output {text[:400]!r}")
            # one process: the launch is checked, not its (empty) result
            check(kernel.ab_fused.launches == 1,
                  f"trainer: launcher ab_fused {kernel.ab_fused.launches}")
            launches += kernel.ab_fused.launches
            check(sorted(os.listdir(ckpt)) == ["step_3", "step_6"],
                  f"trainer: checkpoints {os.listdir(ckpt)}")
            print("  " + " | ".join(line for line in text.splitlines()
                                    if line.startswith(("[train]",
                                                        "[scalana]")))
                  + f"; {secs:.1f} s with checkpoints and the report")
        smoke = dict(arch_cfg=get_smoke(TRAIN_ARCH),
                     shape=ShapeConfig("smoke", 64, 4, "train"))

        def trainer(d):
            return Trainer(RunConfig(arch=TRAIN_ARCH, total_steps=8,
                                     warmup_steps=2, learning_rate=1e-3,
                                     checkpoint_dir=d, checkpoint_every=100,
                                     scalana=False), **smoke)

        once = trainer(f"{tmp}/once")
        once.train(num_steps=8)
        trainer(f"{tmp}/resume").train(num_steps=4)
        resumed = trainer(f"{tmp}/resume")
        resumed.train(num_steps=4)
        want = [m["loss"] for m in once.metrics_log][4:]
        got = [m["loss"] for m in resumed.metrics_log]
        err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        check(resumed.metrics_log[0]["step"] == 4 and err <= RESUME_TOL,
              f"trainer: resumed {got} vs uninterrupted {want}")
        print(f"  resume at the smoke config: 4 + 4 steps across a "
              f"checkpoint = 8 uninterrupted, largest relative difference "
              f"{err:.3g} (tol {RESUME_TOL})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- phase 14: the multi-scale profiling workflow ------------------------

# mamba2-130m at its published width and depth (remat off, as the
# reference's workers run), global batch 4 x 2048 tokens at every scale
SCALE_ARCH, SCALES, SCALE_STEPS = "mamba2-130m", (1, 2, 4), 12
SCALE_SHAPE, SCALE_TIMEOUT_S = (2048, 4), 300       # (seq, global batch)


def phase_scaling(card: str):
    """[scaling]: ``repro_torch.launch.scaling_profile`` at scales 1, 2 and
    4 on the card (each scale its worker processes, one backend for the
    series, detection here): every scale's JSON, congruent PSGs, one
    Comm all-reduce of the model's gradients and loss,
    ``detect_non_scalable`` and ``detect_abnormal`` on the card equal to
    numpy's, a root-cause path.  Returns the (``ab_fused``,
    ``ns_fused``) launches of the detect."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get
    from repro_torch.core import COMM, render_report
    from repro_torch.kernels.detect_fused import kernel
    from repro_torch.launch import scaling_profile as sp
    from repro_torch.launch.mesh import choose_backend
    from repro_torch.models import build_model

    backend = choose_backend("cuda", max(SCALES))
    seq, batch = SCALE_SHAPE
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scaling_")
    try:
        for n in SCALES:
            t0 = time.perf_counter()
            sp.run_scale(n, arch=SCALE_ARCH, full=True, steps=SCALE_STEPS,
                         batch=batch, seq=seq, sample_every=4, out_dir=tmp,
                         device="cuda", timeout_s=SCALE_TIMEOUT_S,
                         backend=backend)
            print(f"  scale {n}: {n} worker processes, backend {backend}, "
                  f"{time.perf_counter() - t0:.1f} s (process start and "
                  f"the trace included)")
        psgs, series, raws = sp.load_series(SCALE_ARCH, SCALES, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nparams = build_model(get(SCALE_ARCH), device="cpu").param_count()
    for n in SCALES:
        raw = raws[n]
        comms = psgs[n].by_kind(COMM)
        check(len(comms) == 1 and comms[0].comm_kind == "all_reduce"
              and comms[0].comm_bytes == 4 * (nparams + 1)
              and comms[0].meta["replica_groups"] == [list(range(n))],
              f"scaling: scale {n} Comm vertices "
              f"{[(v.comm_kind, v.comm_bytes, v.meta) for v in comms]}")
        check(raw["backend"] == backend and raw["config"] == "full"
              and raw["params"] == nparams,
              f"scaling: scale {n} ran {raw['backend']}, {raw['config']}, "
              f"{raw['params']} params")
        t = series[n].times_matrix()[:, comms[0].vid]
        # a ring all-reduce sends 2 (n - 1) / n of the bucket from each
        # rank, at half the NVLink total (one direction)
        ring = 2 * (n - 1) / n * comms[0].comm_bytes
        print(f"  scale {n} ({backend}): median step "
              f"{1e3 * statistics.median(raw['step_times']):.3f} ms (rank 0,"
              f" {[round(1e3 * x, 3) for x in raw['step_times']]}), "
              f"all_reduce v{comms[0].vid} {1e3 * t.mean():.3f} ms mean over"
              f" ranks (max {1e3 * t.max():.3f}; NVLink ring bound with a "
              f"card a rank {1e3 * ring / (h100().NVLINK_BANDWIDTH / 2):.3f}"
              f" ms), {comms[0].comm_bytes:.0f} B; overhead_frac "
              f"{raw['overhead'].get('overhead_frac', 0.0):.4f}; trace "
              f"{raw['trace_s']:.2f} s (rank 0); peak memory "
              f"{sum(raw['peak_bytes']) / 1e9:.2f} GB over the ranks  "
              f"[{card}]")
    kernel.reset_launches()
    ns, ab, paths = sp.diagnose(series, backend="torch", device="cuda")
    launches = (kernel.ab_fused.launches, kernel.ns_fused.launches)
    check(launches[0] >= 1 and launches[1] >= 1,
          f"scaling: launches ab_fused {launches[0]}, ns_fused "
          f"{launches[1]}")
    ns_np, ab_np, paths_np = sp.diagnose(series, backend="numpy")
    check([d.vid for d in ns] == [d.vid for d in ns_np]
          and all(abs(a.slope - b.slope) <= 1e-12 * max(abs(b.slope), 1.0)
                  and abs(a.share - b.share) <= 1e-12 * max(abs(b.share), 1.0)
                  for a, b in zip(ns, ns_np)),
          "scaling: non-scalable differs from numpy")
    check(ab == ab_np, "scaling: abnormal differs from numpy")
    check([p.nodes for p in paths] == [p.nodes for p in paths_np],
          "scaling: paths differ from numpy")
    check(bool(ns) and bool(paths),
          f"scaling: {len(ns)} non-scalable, {len(paths)} paths")
    top = series[max(series)]
    print("  non-scalable: " + ", ".join(
        f"v{d.vid} {d.name} slope {d.slope:+.2f} share {100 * d.share:.1f}%"
        for d in ns))
    print(f"  abnormal at scale {max(SCALES)}: " + (", ".join(
        f"v{a.vid} p{a.proc} {a.name} x{a.ratio:.2f}" for a in ab)
        or "none"))
    print("  root-cause path 0 [" + paths[0].start_reason + "]: " + " <- ".join(
        f"p{p} v{v} {top.psg.vertices[v].name}" for p, v in paths[0].nodes))
    print(f"  ns_fused launches {launches[1]}, ab_fused {launches[0]}; equal "
          f"to numpy; report {len(render_report(top, ns, ab, paths).splitlines())}"
          f" lines; {max(SCALES)} ranks share {torch.cuda.device_count()} "
          f"card(s)")
    return launches


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
        t_diag = time.perf_counter()
        print(f"[diagnose] the paper's example at full width: tinyllama-1.1b "
              f"train steps profiled into a PSG, {DIAG_PROCS}-process "
              f"replay, ab_fused, backtrack; {card}")
        launches["ab_fused"] += phase_diagnose(card)
        print(f"[diagnose] phase wall time "
              f"{time.perf_counter() - t_diag:.1f} s  [{card}]")
        t_mon = time.perf_counter()
        print(f"[monitor] the always-on Monitor at {MON_PROCS} procs over "
              f"{MON_HOSTS} hosts, every detect on the card; {card}")
        kernel.reset_launches()
        mon = phase_monitor(card)
        mon_launches = (kernel.ab_fused.launches, kernel.ns_fused.launches)
        check(mon_launches[0] > 0 and mon_launches[1] == 0,
              f"monitor launches: ab_fused {mon_launches[0]}, "
              f"ns_fused {mon_launches[1]}")
        launches["ab_fused"] += mon_launches[0]
        print(f"[monitor] ab_fused launches {mon_launches[0]}; phase wall "
              f"time {time.perf_counter() - t_mon:.1f} s  [{card}]")
        t_runs = time.perf_counter()
        print(f"[runs] the run store: diff_runs(backend='torch', "
              f"device='cuda'); {card}")
        phase_runs(card, mon)
        print(f"[runs] phase wall time {time.perf_counter() - t_runs:.1f} s"
              f"  [{card}]")
        del mon
        torch.cuda.empty_cache()
        t_moe = time.perf_counter()
        print(f"[moe] the MoE family at full width (depth cut): the flash "
              f"kernel at h = 128, {', '.join(m[0] for m in MOE_MODELS)}; "
              f"{card}")
        flash_layers([c + ("float32",) for c in FLASH_MOE], card)
        flash.flash_attention.launches = 0
        want = phase_moe(card)
        got = flash.flash_attention.launches
        check(got == want, f"moe: flash launches {got}, expected {want}")
        launches["flash_attention"] += got
        print(f"[moe] flash launches {got}; phase wall time "
              f"{time.perf_counter() - t_moe:.1f} s  [{card}]")
        t_serve = time.perf_counter()
        print(f"[serve] ServingEngine at full width on the card: "
              f"{', '.join(m[0] for m in SERVE)}; {card}")
        kernel.reset_launches()
        flash.flash_attention.launches = ssd.ssd_scan.launches = 0
        phase_serve(card)
        served = {"ab_fused": kernel.ab_fused.launches,
                  "ns_fused": kernel.ns_fused.launches,
                  "flash_attention": flash.flash_attention.launches,
                  "ssd_scan": ssd.ssd_scan.launches}
        # the engine decodes token by token through decode_step, which
        # reaches no kernel (the reference's engine reaches no Pallas call)
        check(not any(served.values()), f"serve: kernel launches {served}")
        print(f"[serve] kernel launches {served}; phase wall time "
              f"{time.perf_counter() - t_serve:.1f} s  [{card}]")
        t_zoo = time.perf_counter()
        print(f"[zoo] the rest of the model zoo at full width: the flash "
              f"kernel at h = 256 and non-causal, "
              f"{', '.join(m[0] for m in ZOO_MODELS)}; {card}")
        flash_layers(FLASH_ZOO, card)
        flash.flash_attention.launches = 0
        want = phase_zoo(card)
        got = flash.flash_attention.launches
        check(got == want, f"zoo: flash launches {got}, expected {want}")
        launches["flash_attention"] += got
        print(f"[zoo] flash launches {got}; phase wall time "
              f"{time.perf_counter() - t_zoo:.1f} s  [{card}]")
        torch.cuda.empty_cache()
        t_train = time.perf_counter()
        print(f"[trainer] Trainer on {TRAIN_ARCH} at full width and depth, "
              f"the launcher, resume; {card}")
        launches["ab_fused"] += phase_trainer(card)
        print(f"[trainer] phase wall time "
              f"{time.perf_counter() - t_train:.1f} s  [{card}]")
        torch.cuda.empty_cache()
        t_scale = time.perf_counter()
        print(f"[scaling] scaling_profile at scales {SCALES}, {SCALE_ARCH} "
              f"at full width and depth, global batch {SCALE_SHAPE[1]} x "
              f"{SCALE_SHAPE[0] + 1} tokens, {SCALE_STEPS} steps; {card}")
        ab_n, ns_n = phase_scaling(card)
        launches["ab_fused"] += ab_n
        launches["ns_fused"] += ns_n
        print(f"[scaling] phase wall time "
              f"{time.perf_counter() - t_scale:.1f} s  [{card}]")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    replaces = {"ab_fused": "src/repro/kernels/detect_fused/kernel.py:400",
                "ns_fused": "src/repro/kernels/detect_fused/kernel.py:228",
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

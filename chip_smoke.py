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
   full-width shapes (mamba2's and zamba2's loss shapes, mamba2's
   32768-token prefill, and a (1, 2) rank's share of a one-row loss of
   each: 12 and 40 heads), with its time at each, the plain version's and
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
   zamba2-2.7b (18 of 54 layers) and moonshot-v1-16b-a3b
   (16 layers) serve seeded prompts
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
   (mamba2-130m at full width, 6 of its 24 layers, 12
   steps, each scale its worker processes: NCCL for one rank,
   Gloo for the ranks that time-share the card; detection in this
   process): every scale's JSON with its ``n_procs``, congruent PSGs,
   exactly one Comm all-reduce of 4 x (parameters + 1) bytes, each
   scale's median step and all-reduce times, ``detect_non_scalable``
   (``ns_fused``) and ``detect_abnormal`` (``ab_fused``) on the card
   equal to numpy's, the non-scalable vertices and a root-cause path;
15. tensor — two ranks on a (1, 2) mesh (spawned processes, Gloo, the
   ranks time-sharing the card through the host), each holding its
   parameter shards, against the same work done by this process on the
   card: tinyllama-1.1b at full width, 4 of its 22 layers,
   three train
   steps at tokens (1, 2049) (the losses within 1e-4 relative, each
   rank's step-1 parameters and first moments against its slice of the
   one-process ones; the third step the profiler's sampled replay, then
   one replay timing each collective), the loss through the flash kernel
   on the rank's 16 query and 2 KV heads (8 launches a rank, within 1e-4)
   and
   16 greedy tokens from a 64-token prompt (equal); then
   moonshot-v1-16b-a3b at its published widths, 2 of 48 layers, one
   train step (loss and MoE metrics within 1e-4);
16. tensor-ssm — the flash kernel at the ranks' local shapes (zamba2's 16
   attention heads at h = 80, seamless's 8 in its encoder and decoder)
   against its plain version, with its time, the plain version's, SDPA's
   and the bound (phase 6 holds ``ssd_scan`` at the ranks' 12 and 40
   heads); then two ranks on a (1, 2) mesh as in phase 15,
   against the same work done by this process on the card: mamba2-130m
   and seamless-m4t-medium at full width and depth, three train steps
   each (mamba2 at tokens (1, 2049), seamless at (1, 513) after 1024
   random frames; losses within 1e-4, the step-1 shards checked as in
   phase 15, then the last step repeated with every all-reduce fenced and
   timed), the loss through the kernels on the rank's heads (exact
   launches, within 1e-3 of the rank's plain loss) and 16 greedy tokens
   from a 64-token prompt (equal); mamba2's ``Trainer`` on the mesh, 2
   steps and a checkpoint, 2 more from it, against 4 unbroken (within
   1e-5), the checkpoint then loaded by this process for the same 2 steps
   (within 1e-4 of rank 0's); zamba2-2.7b at full width and 18 of its
   54 layers, the
   kernel loss (18 ``ssd_scan`` and 3 flash launches a rank) and 16
   greedy tokens, then one fenced train step at the deepest cut, a
   multiple of 6 layers up to 18, that the reckoning of
   ``zamba_train_depth`` fits on the card with both ranks (printed as
   ``reduced``);
17. fsdp-sp — four ranks on a ``("data", "model")`` (2, 2) mesh as in
   phase 15 (spawned, Gloo, time-sharing the card), against the same
   work done by this process: tinyllama-1.1b at full width and 2 of its
   22 layers under the baseline, ``gather_weights`` (FSDP storage),
   ``seq_shard`` (sequence parallelism) and both, three steps each at
   tokens (2, 2049) (one for the baseline; losses within 1e-4, each
   rank's step-1 parameters and moments against its slice of the
   one-process ones under its storage), a fenced step timing every
   all-reduce by group, the bytes of the rank's parameters and moments
   (a leaf that ``spec_for`` splits on ``data`` holds exactly half its
   baseline bytes under ``gather_weights``), its peak memory, and the
   loss through the flash kernel on its heads (2 launches, within 1e-3
   of its plain loss); mamba2-130m at full size under the baseline and
   both options the same way (24 ``ssd_scan`` launches a kernel loss);
   one ``seq_shard`` step at 2047 inputs, which do not split (the loss
   within 1e-4); then eight ranks on (1, 8): tinyllama-1.1b at full
   width and 2 of 22 layers, whose 4 KV heads do not divide the axis, so
   the cache's positions are split on ``model``: a 128-token prompt and 16
   greedy tokens equal one process's, the gathered cache within 1e-4;
   then two ranks on (2, 1): zamba2-2.7b at full width and 6 layers
   under ``long_500k``'s rules, a 262784-token prompt prefilled by this
   process (through ``ssd_scan``) into a 524288-position cache, each
   rank decoding 16 greedy tokens from its half (both halves filled),
   equal to one process's.

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
phases 13 and 14 and just after (added to the JSON line's), and each
rank's flash count of phase 15 just before its kernel loss and just
after (added to the JSON line's), and each rank's ``ssd_scan`` and flash
counts of phase 16 just before each kernel loss and prefill and just
after (added to the JSON line's), and each rank's flash and ``ssd_scan``
counts of phase 17 just before each kernel loss and just after, and this
process's ``ssd_scan`` count just before phase 17's long prefill and
just after (added to the JSON line's).
It exits non-zero, printing no
result, when any check fails, when there is no CUDA card, or when the
port is not next to it.  The last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import gc
import json
import os
import queue
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
# loss shapes, mamba2-130m's 32768-token prefill, the loss shapes of a
# rank of [tensor-ssm]'s (1, 2) mesh (12 and 40 heads), and zamba2-2.7b's
# 262784-token prefill of [fsdp-sp]'s long context (4106 chunks of state
# passing; its inputs are drawn on the card)
SSD_SWEEP = [
    (1, 64, 2, 32, 16, 32),
    (2, 128, 4, 64, 32, 64),
    (1, 96, 2, 32, 16, 32),
    (2, 100, 3, 16, 8, 64),
    (1, 256, 1, 64, 64, 64),
    (1, 37, 2, 16, 16, 64),
]
SSD_FULL = [(8, 2048, 24, 64, 128, 64), (2, 2048, 80, 64, 64, 64),
            (1, 32768, 24, 64, 128, 64), (1, 2048, 12, 64, 128, 64),
            (1, 2048, 40, 64, 64, 64)]
SSD_LONG = (1, 128 * 2053, 80, 64, 64, 64)
SSD_FULL.append(SSD_LONG)
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
SERVE = [("tinyllama-1.1b", 8, 4, 8, 32),      # 8 of 22, 8 of 24, 6 of 54
         ("mamba2-130m", 8, 4, 8, 32),         # (one shared-attention
         ("zamba2-2.7b", 6, 2, 4, 16),         # site), 8 of 48: the
         ("moonshot-v1-16b-a3b", 8, 4, 6, 16)]  # script's time (host-bound)
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
    the card; ``SSD_LONG``'s (1.3e9 elements of x) drawn there from the
    same distributions by torch's generator."""
    import numpy as np
    import torch
    B, S, H, Pd, N, _ = case
    if case == SSD_LONG:
        g = torch.Generator("cuda").manual_seed(seed)

        def draw(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        return [draw(B, S, H, Pd), draw(B, S, H).abs_() * 0.1,
                -(draw(H).abs_() + 0.1), draw(B, S, N), draw(B, S, N)]
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
        del args, y, h, yr, hr
    torch.cuda.empty_cache()
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
    2.7b's, mamba2-130m's 32768-token prefill, a tensor-parallel rank's
    of each, zamba2-2.7b's long-context prefill), its plain version on the
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

# mamba2-130m at its published width and 6 of its 24 layers (remat off, as
# the reference's workers run), global batch 4 x 2048 tokens at every scale
SCALE_ARCH, SCALES, SCALE_STEPS = "mamba2-130m", (1, 2, 4), 12
SCALE_LAYERS = 6       # of 24: the script's time with [fsdp-sp]
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
            sp.run_scale(n, arch=SCALE_ARCH, full=True, layers=SCALE_LAYERS,
                         steps=SCALE_STEPS,
                         batch=batch, seq=seq, sample_every=4, out_dir=tmp,
                         device="cuda", timeout_s=SCALE_TIMEOUT_S,
                         backend=backend)
            print(f"  scale {n}: {n} worker processes, backend {backend}, "
                  f"{time.perf_counter() - t0:.1f} s (process start and "
                  f"the trace included)")
        psgs, series, raws = sp.load_series(SCALE_ARCH, SCALES, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nparams = build_model(get(SCALE_ARCH).replace(n_layers=SCALE_LAYERS),
                          device="cpu").param_count()
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


# -- phase 15: tensor parallelism on one card ------------------------------

# two ranks on a (1, 2) mesh time-share the card over Gloo (through the
# host): tinyllama-1.1b at full width, its depth cut to 4 of 22 layers
# (to keep the whole script within its time with phases 16 and 17),
# moonshot-v1-16b-a3b
# at its published widths with its depth cut to 2 of 48 layers
TENSOR_ARCH, TENSOR_LAYERS = "tinyllama-1.1b", 4
TENSOR_MOE, TENSOR_MOE_LAYERS = "moonshot-v1-16b-a3b", 2
TENSOR_SEQ, TENSOR_STEPS, TENSOR_LR = 2048, 3, 1e-4   # tokens (1, 2049)
TENSOR_PROMPT, TENSOR_NEW, TENSOR_TIMEOUT_S = 64, 16, 600
TENSOR_TOL = 1e-4
TENSOR_NOTE = "2 ranks time-share one H100 over Gloo through the host"
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8      # adamw_update's defaults


def _adamw_first_step(old, mu, nu, lr: float, weight_decay: float):
    """AdamW's first step from ``old`` given the moments it left, in
    float32 as ``repro_torch.optim.adamw_update`` computes it."""
    import torch
    bc1 = 1.0 - torch.tensor(ADAM_B1, dtype=torch.float32)
    bc2 = 1.0 - torch.tensor(ADAM_B2, dtype=torch.float32)
    old = old.float()
    delta = (mu / bc1.to(mu.device)) / (torch.sqrt(nu / bc2.to(nu.device))
                                        + ADAM_EPS)
    return old - lr * (delta + weight_decay * old)


def _tensor_batch(cfg, i: int, device):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_dataset
    from repro_torch.training.trainer import to_device
    data = make_dataset(cfg, ShapeConfig("tensor", TENSOR_SEQ, 1, "train"))
    return to_device(data.batch(i), device)


def _tensor_prompt(cfg, device):
    import numpy as np
    import torch
    g = np.random.default_rng(11)
    return torch.from_numpy(g.integers(0, cfg.vocab_size,
                                       size=(1, TENSOR_PROMPT))).to(device)


def _greedy(model, params, prompt):
    import torch
    logits, cache = model.prefill(params, {"tokens": prompt},
                                  TENSOR_PROMPT + TENSOR_NEW)
    toks = []
    for _ in range(TENSOR_NEW):
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
    return torch.cat(toks, 1).cpu().tolist()


def _train_state(params, device):
    import torch
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainState
    return TrainState(params, adamw_init(params), None,
                      torch.zeros((), dtype=torch.int32, device=device))


def _tensor_reference():
    """The one-process runs on the card that the ranks are held against:
    tinyllama's three steps (losses; each rank's shards of the parameters
    and first moments after step 1), its kernel loss and greedy tokens,
    and moonshot's step (loss and MoE metrics)."""
    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed import axes as ax
    from repro_torch.models import build_model
    from repro_torch.models.params import _walk
    from repro_torch.optim.schedule import constant
    from repro_torch.optim.tree import leaves
    from repro_torch.training import make_train_step

    cfg = get(TENSOR_ARCH).replace(n_layers=TENSOR_LAYERS)
    model = build_model(cfg, device="cuda")
    buffers = _shard_buffers(model)
    params = model.init(model.generator(0))
    step = make_train_step(model, RunConfig(), constant(TENSOR_LR))
    state, losses, shards = _train_state(params, "cuda"), [], None
    for i in range(TENSOR_STEPS):
        state, m = step(state, _tensor_batch(cfg, i, "cuda"))
        losses.append(float(m["loss"]))
        if i == 0:
            shards = [_rank_shards(model, state, flat, r)
                      for r, flat in enumerate(buffers)]
    del state
    gc.collect()
    model_k = build_model(cfg.replace(use_kernels=True), device="cuda")
    with torch.no_grad():
        kernel_loss = float(model_k.train_loss(
            params, _tensor_batch(cfg, 0, "cuda"))[0])
        tokens = _greedy(model_k, params, _tensor_prompt(cfg, "cuda"))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = get(TENSOR_MOE).replace(n_layers=TENSOR_MOE_LAYERS)
    mmodel = build_model(mcfg, device="cuda")
    mparams = mmodel.init(mmodel.generator(0))
    mstep = make_train_step(mmodel, RunConfig(), constant(TENSOR_LR))
    mm = mstep(_train_state(mparams, "cuda"),
               _tensor_batch(mcfg, 0, "cuda"))[1]
    moe = {k: float(mm[k]) for k in ("loss", "moe_aux_loss", "moe_z_loss",
                                     "moe_drop_frac")}
    del mparams, mm
    torch.cuda.empty_cache()
    return {"losses": losses, "kernel_loss": kernel_loss, "tokens": tokens,
            "moe": moe, "nparams": (model.param_count(),
                                    mmodel.param_count())}, shards


def _shard_buffers(model) -> list:
    """One buffer a rank for its slices of the step-1 parameters and first
    moments on a (1, 2) mesh, allocated before anything else of the
    phase: the ranks read them through CUDA IPC, which keeps a shared
    allocation's whole segment alive, so each gets a segment of its own
    and frees whole."""
    import torch
    from repro_torch.distributed import axes as ax
    from repro_torch.models.params import _walk
    torch.cuda.empty_cache()
    with ax.use_rules({"data": 1, "model": 2}):
        n = sum(2 * torch.Size(ax.local_shape(sp.axes, sp.shape)).numel()
                for _, sp in _walk(model.specs))
    return [torch.empty(n, dtype=torch.float32, device="cuda")
            for _ in range(2)]


def _rank_shards(model, state, flat, rank: int) -> dict:
    """Rank ``rank``'s slices of ``state``'s parameters and first moments
    as views of its buffer ``flat``."""
    from repro_torch.distributed import axes as ax
    from repro_torch.models.params import _walk
    from repro_torch.optim.tree import leaves
    specs = [sp for _, sp in _walk(model.specs)]
    out, at = {}, 0
    for k, tree in (("params", state.params), ("mu", state.opt.mu)):
        out[k] = []
        for t, sp in zip(leaves(tree), specs):
            with ax.use_rules({"data": 1, "model": 2}):
                part = ax.local_shard(t, sp.axes, rank=rank)
            view = flat[at:at + part.numel()].view(part.shape)
            view.copy_(part)
            out[k].append(view)
            at += part.numel()
    assert at == flat.numel()
    return out


class _CommTimer:
    """A replay of a traced step that fences and times each collective
    (with the wait that completes it), by its group's ranks."""

    def __init__(self, traced):
        import torch.fx

        from repro_torch.core import psg as psg_lib
        timer = self
        self.ms = {}

        class Run(torch.fx.Interpreter):
            def run_node(self, n):
                coll = psg_lib._collective(n)
                waited = psg_lib._waited(n)
                if coll is None and waited is None:
                    return super().run_node(n)
                import torch
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = super().run_node(n)
                torch.cuda.synchronize()
                src = n if coll is not None else waited
                kind, arg = psg_lib._collective(src)
                key = (kind, tuple(psg_lib._group_ranks(src.args[arg])))
                timer.ms[key] = timer.ms.get(key, 0.0) + \
                    1e3 * (time.perf_counter() - t0)
                return out

        self.run = Run(traced.graph_module)


def _tensor_rank(rank: int, init: str, ref: dict, shard: dict, q) -> None:
    """One rank of ``[tensor]``: tinyllama's steps, kernel loss and
    greedy decode, then moonshot's step, each checked here against the
    one-process ``ref`` (``shard``: this rank's slice of its step-1
    parameters and moments); the result dict goes to ``q``."""
    import traceback
    import torch
    import torch.distributed as dist
    out = {"rank": rank}
    sys.path.insert(0, str(ROOT / "src"))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.configs import get
        from repro_torch.configs.base import RunConfig
        from repro_torch.core.profiler import GraphProfiler
        from repro_torch.distributed import axes as ax
        from repro_torch.kernels.flash_attention import kernel as flash
        from repro_torch.launch.mesh import init_group, make_host_mesh
        from repro_torch.models import build_model
        from repro_torch.optim.schedule import constant
        from repro_torch.optim.tree import leaves
        from repro_torch.training import make_train_step

        out["backend"] = init_group(rank, 2, "file://" + init,
                                    device="cuda", timeout_s=300,
                                    backend="gloo")
        mesh = make_host_mesh(2, device="cuda")
        cfg = get(TENSOR_ARCH).replace(n_layers=TENSOR_LAYERS)
        model = build_model(cfg, device="cuda")
        with ax.use_rules(mesh):
            params = model.init(model.generator(0))
            step = make_train_step(model, RunConfig(), constant(TENSOR_LR))
            state = _train_state(params, "cuda")
            t0 = time.perf_counter()
            prof = GraphProfiler(step, (state, _tensor_batch(cfg, 0, "cuda")),
                                 sample_every=TENSOR_STEPS)
            out["trace_s"] = time.perf_counter() - t0
            out["mem_after_trace"] = (torch.cuda.memory_allocated() / 1e9,
                                      torch.cuda.mem_get_info()[0] / 1e9)
            losses, times = [], []
            for i in range(TENSOR_STEPS):
                batch = _tensor_batch(cfg, i, "cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = prof.step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
                if i == 0:
                    err = {}
                    for k, tree in (("params", state.params),
                                    ("mu", state.opt.mu)):
                        err[k] = max(
                            float((a - b).abs().max())
                            / max(float(b.abs().max()), 1e-30)
                            for a, b in zip(leaves(tree), shard[k]))
                    # the second moments hold the one-process gradient:
                    # sqrt(nu / (1 - b2)) = |mu| / (1 - b1) = |g|
                    err["nu"] = max(
                        float((torch.sqrt(v / (1 - ADAM_B2))
                               - m.abs() / (1 - ADAM_B1)).abs().max())
                        / max(float(m.abs().max()) / (1 - ADAM_B1), 1e-30)
                        for v, m in zip(leaves(state.opt.nu), shard["mu"]))
                    # AdamW's first step turns a gradient's round-off
                    # difference into up to lr / eps times that in the
                    # parameter where |g| is near eps, so the new
                    # parameters are held against the first step from this
                    # rank's own moments and old shards, within 1e-6
                    # relative (1e-5 of lr absolute)
                    excess = 0.0
                    for p, p0, m, v in zip(leaves(state.params),
                                           leaves(params),
                                           leaves(state.opt.mu),
                                           leaves(state.opt.nu)):
                        want = _adamw_first_step(
                            p0, m, v, TENSOR_LR, RunConfig().weight_decay)
                        excess = max(excess, float(
                            ((p.float() - want).abs() - 1e-6 * want.abs()
                             - 1e-5 * TENSOR_LR).max()))
                    out["step1"] = {**err, "param_excess": excess}
                    # the process object holds the dict: empty it
                    shard.clear()
                    del p, p0, m, v, want
                    q.put({"rank": rank, "released": True})
            out["losses"], out["step_s"] = losses, times
            out["sampled"] = prof.sampled_steps
            timer = _CommTimer(prof.traced)
            timer.run.run(*prof.traced.flat_args(state, batch))
            out["comm_ms"] = {f"{k[0]} {list(k[1])}": v
                              for k, v in timer.ms.items()}
            out["comm_count"] = len(timer.ms)
            del state, prof, timer
            gc.collect()
            torch.cuda.empty_cache()
            model_k = build_model(cfg.replace(use_kernels=True),
                                  device="cuda")
            flash.flash_attention.launches = 0
            with torch.no_grad():
                out["kernel_loss"] = float(model_k.train_loss(
                    params, _tensor_batch(cfg, 0, "cuda"))[0])
            out["flash_launches"] = flash.flash_attention.launches
            with torch.no_grad():
                out["tokens"] = _greedy(model_k, params,
                                        _tensor_prompt(cfg, "cuda"))
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del params
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mcfg = get(TENSOR_MOE).replace(n_layers=TENSOR_MOE_LAYERS)
            mmodel = build_model(mcfg, device="cuda")
            mparams = mmodel.init(mmodel.generator(0))
            mstep = make_train_step(mmodel, RunConfig(), constant(TENSOR_LR))
            mstate = _train_state(mparams, "cuda")
            mbatch = _tensor_batch(mcfg, 0, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, mm = mstep(mstate, mbatch)
            torch.cuda.synchronize()
            out["moe_step_s"] = time.perf_counter() - t0
            out["moe"] = {k: float(mm[k]) for k in ref["moe"]}
            out["moe_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    except Exception:
        out["error"] = (traceback.format_exc()[-4000:]
                        + f"\nmemory {out.get('mem_after_trace')}")
    finally:
        q.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_tensor(card: str) -> int:
    """[tensor]: two ranks on a (1, 2) mesh on the card against the same
    work in one process.  Returns the ranks' flash launches."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get

    gc.collect()                   # earlier phases' checkpointed steps
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref, shards = _tensor_reference()
    print(f"  one-process reference (tinyllama {ref['nparams'][0]} params, "
          f"{TENSOR_STEPS} steps, kernel loss, decode; moonshot "
          f"{TENSOR_MOE_LAYERS} layers, {ref['nparams'][1]} params, one "
          f"step) {time.perf_counter() - t0:.1f} s: losses "
          f"{[round(x, 6) for x in ref['losses']]}, moonshot "
          f"{ref['moe']}")
    gc.collect()              # checkpointed steps leave reference cycles
    torch.cuda.empty_cache()
    print(f"  this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB"
          f" ({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved) of the "
          f"card for the ranks' step-1 checks")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = tempfile.mktemp(prefix="chip_smoke_tensor_")
    # the ranks' allocators map memory as they grow: two ranks and this
    # process share the card, and cached blocks of one cannot serve another
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_tensor_rank,
                         args=(r, init, ref, shards[r], q))
             for r in range(2)]
    for p in procs:
        p.start()
    outs, released = [], 0
    try:
        while len(outs) < len(procs):
            o = q.get(timeout=TENSOR_TIMEOUT_S)
            if o.get("released"):          # both ranks done with the
                released += 1              # step-1 shards: free them
                if released == len(procs):
                    for d in shards:        # the processes hold the dicts
                        d.clear()
                    torch.cuda.ipc_collect()
                    torch.cuda.empty_cache()
                    print(f"  step-1 shards released: this process holds "
                          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
                continue
            outs.append(o)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(init):
            os.remove(init)
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    outs.sort(key=lambda o: o["rank"])
    for o in outs:
        check("error" not in o, f"tensor: rank {o['rank']} failed:\n"
              f"{o.get('error')}")
    launches = 0
    for o in outs:
        r = o["rank"]
        rel = [abs(a - b) / abs(b) for a, b in zip(o["losses"],
                                                   ref["losses"])]
        check(len(rel) == TENSOR_STEPS and max(rel) <= TENSOR_TOL,
              f"tensor: rank {r} losses {o['losses']} vs {ref['losses']}")
        s1 = o["step1"]
        check(s1["mu"] <= TENSOR_TOL and s1["nu"] <= TENSOR_TOL
              and s1["param_excess"] <= 0.0,
              f"tensor: rank {r} step-1 shards {s1}")
        kl = abs(o["kernel_loss"] - ref["kernel_loss"])
        check(kl <= TENSOR_TOL * abs(ref["kernel_loss"]),
              f"tensor: rank {r} kernel loss {o['kernel_loss']} vs "
              f"{ref['kernel_loss']}")
        # the kernel against the plain path on the same parameters and
        # batch: the rank's first loss, taken before any update
        check(abs(o["kernel_loss"] - o["losses"][0]) < 1e-3,
              f"tensor: rank {r} kernel loss {o['kernel_loss']} vs plain "
              f"{o['losses'][0]}")
        want = TENSOR_LAYERS                   # one flash launch a layer
        check(o["flash_launches"] == want,
              f"tensor: rank {r} flash launches {o['flash_launches']}, "
              f"expected {want}")
        launches += o["flash_launches"]
        check(o["tokens"] == ref["tokens"],
              f"tensor: rank {r} tokens {o['tokens']} vs {ref['tokens']}")
        check(o["comm_count"] > 0 and any(
            k.startswith("all_reduce [0, 1]") for k in o["comm_ms"]),
              f"tensor: rank {r} collectives {o['comm_ms']}")
        for k, want_v in ref["moe"].items():
            got = o["moe"][k]
            check(abs(got - want_v) <= TENSOR_TOL * max(abs(want_v), 1.0),
                  f"tensor: rank {r} moonshot {k} {got} vs {want_v}")
        model_ms = sum(v for k, v in o["comm_ms"].items()
                       if k.startswith("all_reduce [0, 1]"))
        print(f"  rank {r} ({o['backend']}): tinyllama median step "
              f"{1e3 * statistics.median(o['step_s']):.3f} ms "
              f"({[round(1e3 * x, 3) for x in o['step_s']]}; step "
              f"{TENSOR_STEPS} the profiler's sampled replay), losses "
              f"{[round(x, 6) for x in o['losses']]} (max rel "
              f"{max(rel):.2e}); step 1: mu / nu max|d|/max|ref| a leaf "
              f"{s1['mu']:.2e} / {s1['nu']:.2e}, params = AdamW's first "
              f"step from the rank's moments (excess "
              f"{s1['param_excess']:.2e}; max|d|/max|ref| against one "
              f"process a leaf {s1['params']:.2e}); trace "
              f"{o['trace_s']:.2f} s  [{TENSOR_NOTE}; {card}]")
        print(f"  rank {r}: model-axis all-reduces {model_ms:.3f} ms of a "
              f"replayed step ("
              + ", ".join(f"{k}: {v:.3f} ms" for k, v in
                          sorted(o["comm_ms"].items()))
              + f"); kernel loss {o['kernel_loss']:.6f} (one process "
              f"{ref['kernel_loss']:.6f}, plain {o['losses'][0]:.6f}), "
              f"{o['flash_launches']} flash "
              f"launches; {TENSOR_NEW} greedy tokens equal; peak "
              f"{o['peak_gb']:.2f} GB  [{TENSOR_NOTE}; {card}]")
        print(f"  rank {r}: moonshot ({TENSOR_MOE_LAYERS} layers) step "
              f"{1e3 * o['moe_step_s']:.3f} ms, "
              + ", ".join(f"{k} {v:.6f}" for k, v in o["moe"].items())
              + f"; peak {o['moe_peak_gb']:.2f} GB  [{TENSOR_NOTE}; "
              f"{card}]")
    print(f"  ranks' wall {wall:.1f} s (process start, trace and both "
          f"models included)")
    return launches


# -- phase 16: tensor parallelism of the SSM, hybrid and enc-dec families --

# two ranks on a (1, 2) mesh as in [tensor] (spawned, Gloo, time-sharing
# the card): mamba2-130m and seamless-m4t-medium at their published widths
# and depths; zamba2-2.7b at its published width and 18 of its 54 layers
# for the kernel loss and decode, its train step at the depth that fits
# both ranks
TSSM = ("mamba2-130m", "seamless-m4t-medium", "zamba2-2.7b")
TSSM_SEAMLESS_SEQ = 512         # tokens (1, 513) after frames (1, 1024, 1024)
TSSM_TRAINER_STEPS = 2          # then 2 more from the checkpoint = 4 unbroken
RESUME_TOL_TP = 1e-5
# a rank's train step holds about 8.5 f32 copies of its parameters at
# its peak (parameters, moments, gradients, the data bucket and its sum,
# the new state): zamba2-2.7b's step at 36 layers peaked at 29.70 GB a
# rank on an H100 80GB HBM3 at 700 W, 8.3 copies of its 3.38 GB of
# shards over its activations (PERF.md); the two ranks may take 76 GB of
# the 80 GB card, the rest is their contexts and this process
TSSM_STEP_COPIES, TSSM_CARD_GB = 8.5, 76.0
# zamba2-2.7b at 18 of 54 layers (3 shared-attention sites)
# for its kernel loss, decode and train step, to keep the script within
# its time with [fsdp-sp] added
TSSM_ZAMBA_LAYERS = 18
# one zamba2 layer's recompute under remat: what autograd saves for a
# layer's backward with remat off, tools_torch/saved_activations.py at 6
# of zamba2's layers on the host (2.792 MB a token at 256 tokens, 2.829
# at 512: ~3.05 MB a token at 2048, a sixth of it a layer), the shared
# block's site counted whole
ZAMBA_LAYER_SAVED = 3.05e6 * 2048 / 6
# the flash kernel at the ranks' local shapes: zamba2's 16 attention heads
# (h = 80) and seamless's 8 (h = 64) in the encoder (non-causal, 1024
# frames) and decoder (512); [ssm] holds ssd_scan at theirs (SSD_FULL);
# and tinyllama-1.1b's 16 query and 2 KV heads (h = 64) on one row of a
# rank of [fsdp-sp]'s (2, 2) mesh
FLASH_TENSOR = [(1, 16, 16, 2048, 2048, 80, True, "float32"),
                (1, 8, 8, 1024, 1024, 64, False, "float32"),
                (1, 8, 8, 512, 512, 64, True, "float32"),
                (1, 16, 2, 2048, 2048, 64, True, "float32")]


def _local_params(cfg) -> int:
    """Parameters a rank of a (1, 2) mesh holds of ``cfg``."""
    import torch
    from repro_torch.distributed import axes as ax
    from repro_torch.models import build_model
    from repro_torch.models.params import _walk
    model = build_model(cfg, device="cpu")          # specs only
    with ax.use_rules({"data": 1, "model": 2}):
        return sum(torch.Size(ax.local_shape(sp.axes, sp.shape)).numel()
                   for _, sp in _walk(model.specs))


def zamba_train_depth():
    """The deepest cut of zamba2-2.7b, a multiple of ``attn_every``, whose
    train step fits both ranks: each ``TSSM_STEP_COPIES`` f32 copies of
    its parameters, its remat-saved layer inputs (1 x 2048 x d f32 a
    layer) and one layer's recompute (``ZAMBA_LAYER_SAVED``), within
    ``TSSM_CARD_GB``.  Returns (depth, GB a rank at that depth, GB a rank
    at the published depth)."""
    from repro_torch.configs import get
    cfg = get(TSSM[2])

    def gb(n):
        c = cfg.replace(n_layers=n)
        state = TSSM_STEP_COPIES * 4 * _local_params(c)
        acts = n * TENSOR_SEQ * c.d_model * 4 + ZAMBA_LAYER_SAVED
        return (state + acts) / 1e9

    best = max(n for n in range(cfg.attn_every, TSSM_ZAMBA_LAYERS + 1,
                                cfg.attn_every)
               if 2 * gb(n) <= TSSM_CARD_GB)
    return best, gb(best), gb(cfg.n_layers)


def _tssm_cfg(arch: str):
    """``[tensor-ssm]``'s config of ``arch``: zamba2 at
    ``TSSM_ZAMBA_LAYERS`` layers, the others as published."""
    from repro_torch.configs import get
    cfg = get(arch)
    return (cfg.replace(n_layers=TSSM_ZAMBA_LAYERS) if arch == TSSM[2]
            else cfg)


def tssm_launches(cfg, loss: bool) -> dict:
    """A rank's exact kernel launches in a loss (``loss``) or a prefill
    of ``cfg``: one ``ssd_scan`` a Mamba2 layer; one flash a
    self-attention layer of the loss (the hybrid's shared block at each
    site; the encoder's, non-causal, and the decoder's), and the encoder's
    in a prefill (the decoder's self-attention and the shared block's
    prefill take the einsum path, as in the reference)."""
    from repro_torch.models.hybrid import n_attn_sites
    ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    flash = 0
    if cfg.family == "hybrid" and loss:
        flash = n_attn_sites(cfg)
    if cfg.family == "encdec":
        flash = cfg.enc_layers + (cfg.n_layers if loss else 0)
    return {"ssd_scan": ssd, "flash_attention": flash}


def _tssm_batch(cfg, i: int, device):
    """Step ``i``'s batch of the data pipeline at one row: seamless's
    tokens (1, 513) after its 1024 frames, the others' (1, 2049)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_dataset
    from repro_torch.training.trainer import to_device
    seq = TSSM_SEAMLESS_SEQ if cfg.family == "encdec" else TENSOR_SEQ
    data = make_dataset(cfg, ShapeConfig("tensor", seq, 1, "train"))
    return to_device(data.batch(i), device)


def _tssm_greedy(model, params):
    """16 greedy tokens after a seeded 64-token prompt (and 1024 random
    frames for the encoder-decoder)."""
    import torch
    cfg = model.cfg
    batch = zoo_batch(cfg, (1, TENSOR_PROMPT), "cuda", seed=11)
    logits, cache = model.prefill(params, batch, TENSOR_PROMPT + TENSOR_NEW)
    toks = []
    for _ in range(TENSOR_NEW):
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
    return torch.cat(toks, 1).cpu().tolist()


def _step1_errors(state, params, shard, lr: float) -> dict:
    """A rank's first step against this process's: its first and second
    moments against its slice of the one-process first moments (max |d| /
    max |ref| a leaf, and the index of the worst leaf; the second moments
    hold the same gradient), its new
    parameters against AdamW's first step from its own moments and old
    shards (the excess over 1e-6 relative + 1e-5 lr, at most 0)."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.optim.tree import leaves
    err = {}
    for k, tree in (("params", state.params), ("mu", state.opt.mu)):
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(leaves(tree), shard[k])]
        err[k] = max(rel)
        err[k + "_leaf"] = rel.index(err[k])
        err[k + "_leaves"] = rel
    err["nu_leaves"] = [
        float((torch.sqrt(v / (1 - ADAM_B2))
               - m.abs() / (1 - ADAM_B1)).abs().max())
        / max(float(m.abs().max()) / (1 - ADAM_B1), 1e-30)
        for v, m in zip(leaves(state.opt.nu), shard["mu"])]
    err["nu"] = max(err["nu_leaves"])
    excess = 0.0
    for p, p0, m, v in zip(leaves(state.params), leaves(params),
                           leaves(state.opt.mu), leaves(state.opt.nu)):
        want = _adamw_first_step(p0, m, v, lr, RunConfig().weight_decay)
        excess = max(excess, float(((p.float() - want).abs()
                                    - 1e-6 * want.abs() - 1e-5 * lr).max()))
    err["param_excess"] = excess
    return err


class _FencedAllReduce:
    """While active, every functional all-reduce (the model's and the
    step's data bucket) is fenced by ``torch.cuda.synchronize`` and timed,
    by its group's ranks: one step run under it is a fenced step."""

    def __enter__(self):
        import torch
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        self.ms, self.funcol = {}, funcol
        self.orig = orig = funcol.all_reduce

        def timed(t, op, group, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(t, op, group, *args, **kw)
            if isinstance(out, funcol.AsyncCollectiveTensor):
                out = out.wait()
            torch.cuda.synchronize()
            key = f"all_reduce {dist.get_process_group_ranks(group)}"
            self.ms[key] = self.ms.get(key, 0.0) + \
                1e3 * (time.perf_counter() - t0)
            return out

        funcol.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.funcol.all_reduce = self.orig


def _tssm_reference(zamba_depth: int):
    """The one-process runs on the card the ranks are held against:
    mamba2's and seamless's three steps (losses; each rank's shards of
    the step-1 parameters and first moments, in buffers allocated first),
    kernel losses and greedy tokens; zamba2's kernel and plain losses and
    greedy tokens at ``TSSM_ZAMBA_LAYERS``, and its plain loss at
    ``zamba_depth``."""
    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build_model
    from repro_torch.optim.schedule import constant
    from repro_torch.training import make_train_step

    models = {a: build_model(get(a), device="cuda") for a in TSSM[:2]}
    buffers = {a: _shard_buffers(m) for a, m in models.items()}
    ref, shards = {}, [{}, {}]
    for arch, model in models.items():
        cfg = model.cfg
        params = model.init(model.generator(0))
        step = make_train_step(model, RunConfig(), constant(TENSOR_LR))
        state, losses = _train_state(params, "cuda"), []
        for i in range(TENSOR_STEPS):
            state, m = step(state, _tssm_batch(cfg, i, "cuda"))
            losses.append(float(m["loss"]))
            if i == 0:
                for r, flat in enumerate(buffers[arch]):
                    shards[r][arch] = _rank_shards(model, state, flat, r)
        del state, m
        gc.collect()
        model_k = build_model(cfg.replace(use_kernels=True), device="cuda")
        with torch.no_grad():
            kernel = float(model_k.train_loss(
                params, _tssm_batch(cfg, 0, "cuda"))[0])
            tokens = _tssm_greedy(model_k, params)
        ref[arch] = {"losses": losses, "kernel_loss": kernel,
                     "tokens": tokens, "nparams": model.param_count()}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    cfg = _tssm_cfg(TSSM[2])
    for depth in sorted({cfg.n_layers, zamba_depth}):
        c = cfg.replace(n_layers=depth)
        model = build_model(c, device="cuda")
        params = model.init(model.generator(0))
        batch = _tssm_batch(c, 0, "cuda")
        with torch.no_grad():
            plain = float(model.train_loss(params, batch)[0])
            r = {"plain_loss": plain, "nparams": model.param_count()}
            if depth == cfg.n_layers:
                model_k = build_model(c.replace(use_kernels=True),
                                      device="cuda")
                r["kernel_loss"] = float(model_k.train_loss(params,
                                                            batch)[0])
                r["tokens"] = _tssm_greedy(model_k, params)
        ref[TSSM[2], depth] = r
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    return ref, shards


def _tssm_rank(rank: int, init: str, ref: dict, shard: dict, ckpt: str,
               zamba_depth: int, q) -> None:
    """One rank of ``[tensor-ssm]``: mamba2's and seamless's three steps
    (the step-1 shards against ``shard``, a fenced fourth step timing the
    all-reduces), kernel losses and greedy tokens, mamba2's ``Trainer``
    across a checkpoint in ``ckpt``, then zamba2's kernel loss and greedy
    tokens at ``TSSM_ZAMBA_LAYERS`` and one train step at ``zamba_depth``;
    each
    result checked by the caller, the dict put on ``q``."""
    import traceback
    import torch
    import torch.distributed as dist
    out = {"rank": rank}
    sys.path.insert(0, str(ROOT / "src"))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.configs import get
        from repro_torch.configs.base import RunConfig, ShapeConfig
        from repro_torch.distributed import axes as ax
        from repro_torch.kernels.flash_attention import kernel as flash
        from repro_torch.kernels.ssd_scan import kernel as ssd
        from repro_torch.launch.mesh import init_group, make_host_mesh
        from repro_torch.models import build_model
        from repro_torch.optim.schedule import constant
        from repro_torch.training import make_train_step
        from repro_torch.training.trainer import Trainer

        def kernel_counts():
            return {"ssd_scan": ssd.ssd_scan.launches,
                    "flash_attention": flash.flash_attention.launches}

        def reset_counts():
            ssd.ssd_scan.launches = flash.flash_attention.launches = 0

        out["backend"] = init_group(rank, 2, "file://" + init,
                                    device="cuda", timeout_s=300,
                                    backend="gloo")
        mesh = make_host_mesh(2, device="cuda")
        for arch in TSSM[:2]:
            cfg = get(arch)
            res = out[arch] = {}
            torch.cuda.reset_peak_memory_stats()
            model = build_model(cfg, device="cuda")
            with ax.use_rules(mesh):
                params = model.init(model.generator(0))
                step = make_train_step(model, RunConfig(),
                                       constant(TENSOR_LR))
                state, losses, times = _train_state(params, "cuda"), [], []
                for i in range(TENSOR_STEPS):
                    batch = _tssm_batch(cfg, i, "cuda")
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    new, m = step(state, batch)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    losses.append(float(m["loss"]))
                    if i == 0:
                        res["step1"] = _step1_errors(new, params,
                                                     shard[arch], TENSOR_LR)
                        shard[arch].clear()     # the process holds the dict
                        q.put({"rank": rank, "released": arch})
                    if i < TENSOR_STEPS - 1:
                        state = new
                    del new, m
                # a fenced repeat of the last step, its collectives timed
                with _FencedAllReduce() as fenced:
                    step(state, batch)
                res["comm_ms"] = fenced.ms
                res["losses"], res["step_s"] = losses, times
                del state, batch
                gc.collect()
                model_k = build_model(cfg.replace(use_kernels=True),
                                      device="cuda")
                reset_counts()
                with torch.no_grad():
                    res["kernel_loss"] = float(model_k.train_loss(
                        params, _tssm_batch(cfg, 0, "cuda"))[0])
                    res["loss_launches"] = kernel_counts()
                    reset_counts()
                    res["tokens"] = _tssm_greedy(model_k, params)
                    res["greedy_launches"] = kernel_counts()
                res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del params, model_k
            gc.collect()
            torch.cuda.empty_cache()
        # mamba2's Trainer on the mesh: 2 steps and a checkpoint, 2 more
        # from it, against 4 unbroken; each rank joins every save's gather
        tshape = ShapeConfig("tensor", TENSOR_SEQ, 1, "train")

        def trainer(directory):
            run = RunConfig(arch=TSSM[0], total_steps=2 * TSSM_TRAINER_STEPS,
                            learning_rate=TENSOR_LR, warmup_steps=1,
                            checkpoint_dir=directory, checkpoint_every=100,
                            scalana=False)
            return Trainer(run, mesh=mesh, arch_cfg=get(TSSM[0]),
                           shape=tshape, device="cuda")

        def trained(tr, n):
            tr.train(num_steps=n)
            return [x["loss"] for x in tr.metrics_log if "loss" in x]

        t0 = time.perf_counter()
        split = trained(trainer(ckpt), TSSM_TRAINER_STEPS) + \
            trained(trainer(ckpt), TSSM_TRAINER_STEPS)
        out["trainer"] = {"split": split, "written": sorted(os.listdir(ckpt)),
                          "unbroken": trained(trainer(""),
                                              2 * TSSM_TRAINER_STEPS),
                          "wall_s": time.perf_counter() - t0}
        gc.collect()
        torch.cuda.empty_cache()
        # zamba2: the kernel loss and greedy tokens
        cfg = _tssm_cfg(TSSM[2])
        res = out[TSSM[2]] = {}
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device="cuda")
        model_k = build_model(cfg.replace(use_kernels=True), device="cuda")
        with ax.use_rules(mesh), torch.no_grad():
            params = model.init(model.generator(0))
            batch = _tssm_batch(cfg, 0, "cuda")
            res["plain_loss"] = float(model.train_loss(params, batch)[0])
            reset_counts()
            res["kernel_loss"] = float(model_k.train_loss(params, batch)[0])
            res["loss_launches"] = kernel_counts()
            reset_counts()
            res["tokens"] = _tssm_greedy(model_k, params)
            res["greedy_launches"] = kernel_counts()
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        # one train step at the depth that fits both ranks
        torch.cuda.reset_peak_memory_stats()
        cfg = cfg.replace(n_layers=zamba_depth)
        model = build_model(cfg, device="cuda")
        with ax.use_rules(mesh):
            params = model.init(model.generator(0))
            step = make_train_step(model, RunConfig(), constant(TENSOR_LR))
            batch = _tssm_batch(cfg, 0, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _FencedAllReduce() as fenced:
                _, m = step(_train_state(params, "cuda"), batch)
            torch.cuda.synchronize()
            res["step_s"] = time.perf_counter() - t0
            res["step_loss"] = float(m["loss"])
            res["step_comm_ms"] = fenced.ms
        res["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, m
    except Exception:
        out["error"] = traceback.format_exc()[-4000:]
    finally:
        q.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def _one_process_resume(ckpt: str) -> list:
    """mamba2's (1, 2) checkpoint of step 2, loaded by one process on the
    card and trained 2 more steps: its losses."""
    import shutil
    from repro_torch.configs import get
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.training.trainer import Trainer
    one = ckpt + ".one"
    shutil.copytree(os.path.join(ckpt, f"step_{TSSM_TRAINER_STEPS}"),
                    os.path.join(one, f"step_{TSSM_TRAINER_STEPS}"))
    run = RunConfig(arch=TSSM[0], total_steps=2 * TSSM_TRAINER_STEPS,
                    learning_rate=TENSOR_LR, warmup_steps=1,
                    checkpoint_dir=one, checkpoint_every=100, scalana=False)
    tr = Trainer(run, arch_cfg=get(TSSM[0]),
                 shape=ShapeConfig("tensor", TENSOR_SEQ, 1, "train"),
                 device="cuda")
    tr.train(num_steps=TSSM_TRAINER_STEPS)
    check(tr.metrics_log[0]["step"] == TSSM_TRAINER_STEPS,
          f"tensor-ssm: one process resumed at {tr.metrics_log[0]}")
    shutil.rmtree(one, ignore_errors=True)
    return [x["loss"] for x in tr.metrics_log if "loss" in x]


def phase_tensor_ssm(card: str) -> dict:
    """[tensor-ssm]: two ranks on a (1, 2) mesh on the card against the
    same work in one process, for mamba2, seamless and zamba2.  Returns
    the ranks' kernel launches by kernel."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get
    from repro_torch.models import build_model
    from repro_torch.models.params import _walk

    flash_layers(FLASH_TENSOR, card)
    depth, gb, gb_full = zamba_train_depth()
    print(f"  reduced: {TSSM[2]}'s train step at {depth} of "
          f"{get(TSSM[2]).n_layers} layers: ~{gb:.1f} GB a rank reckoned "
          f"({TSSM_STEP_COPIES} f32 copies of its parameters + remat "
          f"inputs + a layer's recompute), ~{gb_full:.1f} GB at full "
          f"depth; two ranks within {TSSM_CARD_GB:.0f} GB of the card")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref, shards = _tssm_reference(depth)
    full = ref[TSSM[2], TSSM_ZAMBA_LAYERS]
    print(f"  one-process reference {time.perf_counter() - t0:.1f} s "
          f"[{card}]: "
          + "; ".join(f"{a} losses {[round(x, 6) for x in ref[a]['losses']]}"
                      for a in TSSM[:2])
          + f"; {TSSM[2]} plain loss {full['plain_loss']:.6f}, kernel "
          f"{full['kernel_loss']:.6f}, at {depth} layers "
          f"{ref[TSSM[2], depth]['plain_loss']:.6f}")
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = tempfile.mktemp(prefix="chip_smoke_tensor_ssm_")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_tensor_ckpt_")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_tssm_rank,
                         args=(r, init, ref, shards[r], ckpt, depth, q))
             for r in range(2)]
    for p in procs:
        p.start()
    outs, released = [], {}
    try:
        while len(outs) < len(procs):
            o = q.get(timeout=TENSOR_TIMEOUT_S)
            if o.get("released"):           # both ranks done with a
                arch = o["released"]         # model's step-1 shards
                released[arch] = released.get(arch, 0) + 1
                if released[arch] == len(procs):
                    for d in shards:
                        d.pop(arch).clear()
                    torch.cuda.ipc_collect()
                    torch.cuda.empty_cache()
                continue
            outs.append(o)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(init):
            os.remove(init)
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    wall = time.perf_counter() - t0
    outs.sort(key=lambda o: o["rank"])
    for o in outs:
        check("error" not in o, f"tensor-ssm: rank {o['rank']} failed:\n"
              f"{o.get('error')}")
    try:
        resumed = _one_process_resume(ckpt)
    finally:
        import shutil
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = {"ssd_scan": 0, "flash_attention": 0}
    want_loss = {a: tssm_launches(_tssm_cfg(a), True) for a in TSSM}
    want_greedy = {a: tssm_launches(_tssm_cfg(a), False) for a in TSSM}
    for o in outs:
        r = o["rank"]
        for arch in TSSM:
            res, want = o[arch], ref.get(arch) or ref[
                arch, _tssm_cfg(arch).n_layers]
            for k in ("loss_launches", "greedy_launches"):
                exp = (want_loss if k == "loss_launches" else
                       want_greedy)[arch]
                check(res[k] == exp, f"tensor-ssm: rank {r} {arch} {k} "
                      f"{res[k]}, expected {exp}")
                for n, c in res[k].items():
                    launches[n] += c
            check(res["tokens"] == want["tokens"],
                  f"tensor-ssm: rank {r} {arch} tokens {res['tokens']} vs "
                  f"{want['tokens']}")
            plain = res["losses"][0] if "losses" in res else \
                res["plain_loss"]
            check(abs(res["kernel_loss"] - plain) < 1e-3,
                  f"tensor-ssm: rank {r} {arch} kernel loss "
                  f"{res['kernel_loss']} vs plain {plain}")
            check(abs(res["kernel_loss"] - want["kernel_loss"])
                  <= TENSOR_TOL * abs(want["kernel_loss"]),
                  f"tensor-ssm: rank {r} {arch} kernel loss "
                  f"{res['kernel_loss']} vs one process "
                  f"{want['kernel_loss']}")
        for arch in TSSM[:2]:
            res, want = o[arch], ref[arch]
            names = ["/".join(p) for p, _ in _walk(
                build_model(get(arch), device="cpu").specs)]
            rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                       want["losses"])]
            check(len(rel) == TENSOR_STEPS and max(rel) <= TENSOR_TOL,
                  f"tensor-ssm: rank {r} {arch} losses {res['losses']} vs "
                  f"{want['losses']}")
            s1 = res["step1"]
            check(s1["mu"] <= TENSOR_TOL and s1["nu"] <= TENSOR_TOL
                  and s1["param_excess"] <= 0.0,
                  f"tensor-ssm: rank {r} {arch} step-1 shards {s1}")
            model_ms = sum(v for k, v in res["comm_ms"].items()
                           if k == "all_reduce [0, 1]")
            check(model_ms > 0, f"tensor-ssm: rank {r} {arch} collectives "
                  f"{res['comm_ms']}")
            print(f"  rank {r} ({o['backend']}): {arch} ({want['nparams']} "
                  f"params) median step "
                  f"{1e3 * statistics.median(res['step_s']):.3f} ms "
                  f"({[round(1e3 * x, 3) for x in res['step_s']]}), losses "
                  f"{[round(x, 6) for x in res['losses']]} (max rel "
                  f"{max(rel):.2e}); step 1: mu / nu {s1['mu']:.2e} / "
                  f"{s1['nu']:.2e} (mu's worst leaf {names[s1['mu_leaf']]}),"
                  f" params excess {s1['param_excess']:.2e};"
                  f" a fenced step's model-axis all-reduces "
                  f"{model_ms:.3f} ms ("
                  + ", ".join(f"{k}: {v:.3f} ms" for k, v in
                              sorted(res["comm_ms"].items()))
                  + f"); kernel loss {res['kernel_loss']:.6f} (plain "
                  f"{res['losses'][0]:.6f}, one process "
                  f"{want['kernel_loss']:.6f}), launches "
                  f"{res['loss_launches']} a loss, "
                  f"{res['greedy_launches']} a prefill; {TENSOR_NEW} greedy "
                  f"tokens equal; peak {res['peak_gb']:.2f} GB  "
                  f"[{TENSOR_NOTE}; {card}]")
        tr = o["trainer"]
        d = max(abs(a - b) for a, b in zip(tr["split"], tr["unbroken"]))
        check(len(tr["split"]) == 2 * TSSM_TRAINER_STEPS
              and d <= RESUME_TOL_TP * max(abs(x) for x in tr["unbroken"]),
              f"tensor-ssm: rank {r} Trainer {tr['split']} vs unbroken "
              f"{tr['unbroken']}")
        check(tr["written"] == [f"step_{TSSM_TRAINER_STEPS}",
                                f"step_{2 * TSSM_TRAINER_STEPS}"],
              f"tensor-ssm: rank {r} checkpoint directory {tr['written']}")
        print(f"  rank {r}: {TSSM[0]} Trainer {TSSM_TRAINER_STEPS} + "
              f"{TSSM_TRAINER_STEPS} steps across a checkpoint "
              f"{[round(x, 6) for x in tr['split']]} = unbroken (max |d| "
              f"{d:.2e}); {tr['wall_s']:.1f} s  [{TENSOR_NOTE}; {card}]")
        res = o[TSSM[2]]
        want_step = ref[TSSM[2], depth]["plain_loss"]
        check(abs(res["step_loss"] - want_step) <= TENSOR_TOL * want_step,
              f"tensor-ssm: rank {r} {TSSM[2]} step loss "
              f"{res['step_loss']} vs one process {want_step}")
        model_ms = sum(v for k, v in res["step_comm_ms"].items()
                       if k == "all_reduce [0, 1]")
        print(f"  rank {r}: {TSSM[2]} at {TSSM_ZAMBA_LAYERS} layers: "
              f"kernel loss "
              f"{res['kernel_loss']:.6f} (plain {res['plain_loss']:.6f}), "
              f"launches {res['loss_launches']} a loss, "
              f"{res['greedy_launches']} a prefill, {TENSOR_NEW} greedy "
              f"tokens equal, peak {res['peak_gb']:.2f} GB; at {depth} "
              f"layers one fenced step {1e3 * res['step_s']:.3f} ms "
              f"(model-axis all-reduces {model_ms:.3f} ms), loss "
              f"{res['step_loss']:.6f} (one process {want_step:.6f}), "
              f"peak {res['step_peak_gb']:.2f} GB  [{TENSOR_NOTE}; {card}]")
    last = outs[0]["trainer"]["split"][-TSSM_TRAINER_STEPS:]
    d = max(abs(a - b) for a, b in zip(resumed, last))
    check(d <= TENSOR_TOL * max(abs(x) for x in last),
          f"tensor-ssm: one process from the (1, 2) checkpoint {resumed} vs "
          f"rank 0 {last}")
    print(f"  the (1, 2) checkpoint of step {TSSM_TRAINER_STEPS} loaded by "
          f"one process on the card: losses {[round(x, 6) for x in resumed]}"
          f" (rank 0 {[round(x, 6) for x in last]}, max |d| {d:.2e})")
    print(f"  ranks' wall {wall:.1f} s (process start and every model "
          f"included); launches {launches}  [{TENSOR_NOTE}; {card}]")
    return launches


# -- phase 17: FSDP storage, sequence parallelism and the split cache ----

# four ranks on a ("data", "model") (2, 2) mesh (spawned, Gloo, time-sharing
# the card as in [tensor]): tinyllama-1.1b at full width and 2 of its 22
# layers (four ranks and this process share the card, and Gloo moves every
# gather and scatter through the host: each layer a step costs several
# round trips of 16 MB activations and 90 MB weight shards; the script
# must end within its time on a slow host), and
# mamba2-130m at full size; then the GQA decode fallback on (1, 8) and
# long-context decode on (2, 1)
FSDP_NOTE = "ranks time-share one H100 over Gloo through the host"
FSDP_ARCH, FSDP_LAYERS, FSDP_SSM = "tinyllama-1.1b", 2, "mamba2-130m"
FSDP_SEQ, FSDP_ODD, FSDP_BATCH = 2048, 2047, 2   # inputs; one row a data rank
FSDP_STEPS, FSDP_TIMEOUT_S = 3, 900
# option sets: (gather_weights, res_seq on model)
FSDP_RUNS = {"baseline": (False, False), "gather_weights": (True, False),
             "seq_shard": (False, True), "both": (True, True)}
FSDP_SSM_RUNS = ("baseline", "both")
FALLBACK_RANKS, FALLBACK_PROMPT = 8, 128    # max_len 144: 18 positions a rank
FALLBACK_LAYERS = 2        # of 22: eight ranks' decode step is ~6
#                            collectives a layer through the host
LONG_ARCH, LONG_LAYERS = "zamba2-2.7b", 6   # one shared-attention site
LONG_MAX = 524288                            # long_500k's cache
LONG_PROMPT = SSD_LONG[1]  # 640 positions past the first rank's half; the
#                            prefill's attention chunks are 128 queries
#                            (4.3 GB of f32 scores a chunk); [ssm] holds
#                            ssd_scan at this prefill's shape (SSD_LONG)


def _fsdp_batch(cfg, i: int, seq: int, device, shard=(1, 0)):
    """Step ``i``'s global batch of ``FSDP_BATCH`` rows at ``seq`` inputs,
    or batch rank ``shard[1]``'s of ``shard[0]``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_dataset
    from repro_torch.training.trainer import to_device
    data = make_dataset(cfg, ShapeConfig("fsdp", seq, FSDP_BATCH, "train"))
    return to_device(data.shard(*shard).batch(i), device)


def _fsdp_cfgs():
    from repro_torch.configs import get
    return {FSDP_ARCH: get(FSDP_ARCH).replace(n_layers=FSDP_LAYERS),
            FSDP_SSM: get(FSDP_SSM)}


def _fsdp_reference():
    """This process's runs that the (2, 2) ranks are held against: each
    model's three steps on the global batch (losses; the whole step-1
    parameters and first moments, in one buffer a model that the ranks
    read through CUDA IPC), and tinyllama's step at the odd length.  And
    the noise floor of the first moments: the first step again as two
    microbatches of one row, the sum of two halves that a data-parallel
    step takes too; its max |d| / max |ref| a leaf against the one-batch
    step is what splitting the batch alone does to an f32 sum."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build_model
    from repro_torch.optim.schedule import constant
    from repro_torch.optim.tree import leaves
    from repro_torch.training import make_train_step
    ref, whole = {}, {}
    for arch, cfg in _fsdp_cfgs().items():
        model = build_model(cfg, device="cuda")
        n = model.param_count()
        flat = torch.empty(2 * n, dtype=torch.float32, device="cuda")
        params = model.init(model.generator(0))
        step = make_train_step(model, RunConfig(), constant(TENSOR_LR))
        state, losses = _train_state(params, "cuda"), []
        for i in range(FSDP_STEPS):
            state, m = step(state, _fsdp_batch(cfg, i, FSDP_SEQ, "cuda"))
            losses.append(float(m["loss"]))
            if i == 0:
                at, views = 0, {}
                for k, tree in (("params", state.params),
                                ("mu", state.opt.mu)):
                    views[k] = []
                    for t in leaves(tree):
                        v = flat[at:at + t.numel()].view(t.shape)
                        v.copy_(t)
                        views[k].append(v)
                        at += t.numel()
                whole[arch] = views
        halves = make_train_step(model, RunConfig(microbatch=2),
                                 constant(TENSOR_LR))(
            _train_state(params, "cuda"),
            _fsdp_batch(cfg, 0, FSDP_SEQ, "cuda"))[0]
        noise = [float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                 for a, b in zip(leaves(halves.opt.mu), whole[arch]["mu"])]
        del halves
        ref[arch] = {"losses": losses, "nparams": n, "noise": noise}
        if arch == FSDP_ARCH:
            ref[arch]["odd_loss"] = float(step(
                _train_state(params, "cuda"),
                _fsdp_batch(cfg, 0, FSDP_ODD, "cuda"))[1]["loss"])
        del state, params, m
        gc.collect()
        torch.cuda.empty_cache()
    return ref, whole


def _fsdp_rank(rank: int, init: str, whole: dict, q) -> None:
    """One rank of ``[fsdp-sp]``'s (2, 2) mesh: each model under each
    option set (``FSDP_RUNS``), three steps (one for the baseline) with
    the step-1 shards against its slices of ``whole`` (this process's
    step-1 state), a fenced fourth step timing every all-reduce by group,
    its tensors' bytes, its peak memory and the loss through the kernels;
    then tinyllama's ``seq_shard`` step at the odd length.  The result
    dict goes to ``q``."""
    import traceback
    import torch
    import torch.distributed as dist
    out = {"rank": rank, "runs": {}}
    sys.path.insert(0, str(ROOT / "src"))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.configs.base import RunConfig
        from repro_torch.distributed import axes as ax
        from repro_torch.kernels.flash_attention import kernel as flash
        from repro_torch.kernels.ssd_scan import kernel as ssd
        from repro_torch.launch.mesh import init_group, make_host_mesh
        from repro_torch.models import build_model
        from repro_torch.models.params import _walk
        from repro_torch.optim.schedule import constant
        from repro_torch.optim.tree import leaves
        from repro_torch.training import make_train_step

        out["backend"] = init_group(rank, 4, "file://" + init,
                                    device="cuda", timeout_s=600,
                                    backend="gloo")
        mesh = make_host_mesh(2, device="cuda")
        shard = ax.batch_coord(mesh)
        for arch, cfg in _fsdp_cfgs().items():
            model = build_model(cfg, device="cuda")
            model_k = build_model(cfg.replace(use_kernels=True),
                                  device="cuda")
            specs = [sp for _, sp in _walk(model.specs)]
            runs = FSDP_RUNS if arch == FSDP_ARCH else {
                k: FSDP_RUNS[k] for k in FSDP_SSM_RUNS}
            for name, (gw, sp) in runs.items():
                rules = dict(ax.DEFAULT_RULES, res_seq="model") if sp \
                    else None
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                r = {}
                with ax.use_rules(mesh, rules, {"gather_weights": gw}):
                    r["sp"] = ax.seq_parallel(FSDP_SEQ)
                    r["split"] = [ax.data_dim(s.axes, s.shape) is not None
                                  for s in specs]
                    params = model.init(model.generator(0))
                    mine = {k: [ax.local_shard(t, s.axes)
                                for t, s in zip(whole[arch][k], specs)]
                            for k in ("params", "mu")}
                    step = make_train_step(model, RunConfig(),
                                           constant(TENSOR_LR))
                    state = _train_state(params, "cuda")
                    losses, times = [], []
                    n_steps = 1 if name == "baseline" else FSDP_STEPS
                    for i in range(n_steps):
                        batch = _fsdp_batch(cfg, i, FSDP_SEQ, "cuda", shard)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        state, m = step(state, batch)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        losses.append(float(m["loss"]))
                        if i == 0:
                            r["step1"] = _step1_errors(state, params, mine,
                                                       TENSOR_LR)
                    del mine
                    r["bytes"] = {k: [t.nbytes for t in leaves(tree)]
                                  for k, tree in (
                                      ("params", state.params),
                                      ("mu", state.opt.mu),
                                      ("nu", state.opt.nu))}
                    with _FencedAllReduce() as fence:
                        step(state, batch)
                    r["comm_ms"] = fence.ms
                    del state, m
                    gc.collect()
                    batch0 = _fsdp_batch(cfg, 0, FSDP_SEQ, "cuda", shard)
                    flash.flash_attention.launches = 0
                    ssd.ssd_scan.launches = 0
                    with torch.no_grad():
                        r["kernel_loss"] = float(model_k.train_loss(
                            params, batch0)[0])
                        n_k = (flash.flash_attention.launches,
                               ssd.ssd_scan.launches)
                        # the rank's own batch: the plain loss beside it
                        r["plain_loss"] = float(model.train_loss(
                            params, batch0)[0])
                    r["launches"] = {"flash_attention": n_k[0],
                                     "ssd_scan": n_k[1]}
                    r["losses"], r["step_s"] = losses, times
                    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                    del params
                out["runs"][arch, name] = r
            del model, model_k
        cfg = _fsdp_cfgs()[FSDP_ARCH]
        model = build_model(cfg, device="cuda")
        with ax.use_rules(mesh, dict(ax.DEFAULT_RULES, res_seq="model")):
            out["odd_sp"] = ax.seq_parallel(FSDP_ODD)
            params = model.init(model.generator(0))
            step = make_train_step(model, RunConfig(), constant(TENSOR_LR))
            out["odd_loss"] = float(step(
                _train_state(params, "cuda"),
                _fsdp_batch(cfg, 0, FSDP_ODD, "cuda", shard))[1]["loss"])
    except Exception:
        out["error"] = traceback.format_exc()[-4000:]
    finally:
        q.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def _fallback_rank(rank: int, init: str, q) -> None:
    """One rank of the GQA decode fallback on (1, 8): tinyllama-1.1b at
    full width and ``FALLBACK_LAYERS`` layers under ``rules_for_shape``'s
    rules (its 4 KV heads
    do not divide the axis: the cache's positions on ``model``), a
    128-token prompt prefilled and 16 greedy tokens; the cache gathered on
    positions."""
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    out = {"rank": rank}
    sys.path.insert(0, str(ROOT / "src"))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.configs import get
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.distributed import axes as ax
        from repro_torch.launch.mesh import init_group, make_host_mesh
        from repro_torch.launch.shardings import rules_for_shape
        from repro_torch.models import build_model
        init_group(rank, FALLBACK_RANKS, "file://" + init, device="cuda",
                   timeout_s=600, backend="gloo")
        mesh = make_host_mesh(FALLBACK_RANKS, device="cuda")
        cfg = get(FSDP_ARCH).replace(n_layers=FALLBACK_LAYERS)
        max_len = FALLBACK_PROMPT + TENSOR_NEW
        rules = rules_for_shape(ShapeConfig("d", max_len, 1, "decode"), cfg,
                                mesh)
        out["rules"] = (rules["kv_seq"], rules["kv_heads"])
        model = build_model(cfg, device="cuda")
        prompt = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, size=(1, FALLBACK_PROMPT))).to("cuda")
        with ax.use_rules(mesh, rules), torch.no_grad():
            params = model.init(model.generator(0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": prompt}, max_len)
            toks, steps = [], []
            for _ in range(TENSOR_NEW):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                toks.append(tok)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tok)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t1)
            out["wall_s"] = time.perf_counter() - t0
            out["decode_s"] = steps
            out["tokens"] = torch.cat(toks, 1).cpu().tolist()
            out["local"] = tuple(cache.kv.k.shape)
            group = ax.group_of(("model",))[0]
            # numpy: a CPU tensor would pass the queue as a file
            # descriptor that dies with this process
            out["k"] = ax._gathered(cache.kv.k, 2, group).cpu().numpy()
            out["v"] = ax._gathered(cache.kv.v, 2, group).cpu().numpy()
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    except Exception:
        out["error"] = traceback.format_exc()[-4000:]
    finally:
        q.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def _long_rank(rank: int, init: str, cache: tuple, first, q) -> None:
    """One rank of long-context decode on a ("data", "model") (2, 1)
    mesh: zamba2-2.7b at full width and ``LONG_LAYERS`` layers under
    ``long_500k``'s rules (the cache's positions on the batch axes), its
    half of this process's prefilled cache (``cache``: conv and SSM
    states, K, V and lengths, read through CUDA IPC and copied), 16
    greedy tokens from ``first``."""
    import traceback
    import torch
    import torch.distributed as dist
    out = {"rank": rank}
    sys.path.insert(0, str(ROOT / "src"))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.configs import SHAPES, get
        from repro_torch.distributed import axes as ax
        from repro_torch.launch.mesh import init_group, make_host_mesh
        from repro_torch.launch.shardings import rules_for_shape
        from repro_torch.models import build_model
        from repro_torch.models.hybrid import HybridCache
        from repro_torch.models.mamba2 import SSMState
        init_group(rank, 2, "file://" + init, device="cuda", timeout_s=600,
                   backend="gloo")
        mesh = make_host_mesh(1, device="cuda")
        cfg = get(LONG_ARCH).replace(n_layers=LONG_LAYERS)
        rules = rules_for_shape(SHAPES["long_500k"], cfg, mesh)
        out["rules"] = rules["kv_seq"]
        model = build_model(cfg, device="cuda")
        conv, h, k, v, length = cache
        half = LONG_MAX // 2
        with ax.use_rules(mesh, rules), torch.no_grad():
            params = model.init(model.generator(0))
            mine = HybridCache(SSMState(conv.clone(), h.clone()),
                               k[:, :, rank * half:(rank + 1) * half].clone(),
                               v[:, :, rank * half:(rank + 1) * half].clone(),
                               length.clone())
            del conv, h, k, v, length, cache
            q.put({"rank": rank, "copied": True})
            out["local"] = tuple(mine.k.shape)
            tok, toks, steps = first.clone(), [], []
            for _ in range(TENSOR_NEW):
                toks.append(tok)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, mine = model.decode_step(params, mine, tok)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                tok = torch.argmax(logits[:, -1], -1)[:, None]
            out["tokens"] = torch.cat(toks, 1).cpu().tolist()
            out["decode_s"] = steps
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    except Exception:
        out["error"] = traceback.format_exc()[-4000:]
    finally:
        q.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(target, n: int, args, on_message=None) -> list:
    """Run ``target(rank, init, *args, q)`` in ``n`` spawned processes;
    their result dicts by rank (``on_message`` sees the others)."""
    import tempfile
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = tempfile.mktemp(prefix="chip_smoke_fsdp_")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    procs = [ctx.Process(target=target, args=(r, init, *args, q))
             for r in range(n)]
    for p in procs:
        p.start()
    outs, deadline = [], time.perf_counter() + FSDP_TIMEOUT_S
    try:
        while len(outs) < n:
            try:
                o = q.get(timeout=10)
            except queue.Empty:        # a rank that died sends nothing
                codes = [p.exitcode for p in procs]
                check(all(c in (None, 0) for c in codes)
                      and time.perf_counter() < deadline,
                      f"fsdp-sp: {target.__name__}: rank exit codes {codes}"
                      f" after {len(outs)} results")
                continue
            if "copied" in o:
                if on_message is not None:
                    on_message(o)
                continue
            outs.append(o)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(init):
            os.remove(init)
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    outs.sort(key=lambda o: o["rank"])
    for o in outs:
        check("error" not in o, f"fsdp-sp: rank {o['rank']} of "
              f"{target.__name__} failed:\n{o.get('error')}")
    return outs


def _long_reference():
    """zamba2-2.7b at ``LONG_LAYERS`` layers, one process: a
    ``LONG_PROMPT``-token prompt prefilled (``ssd_scan`` on the SSD
    layers) into a cache of ``LONG_MAX`` positions, then 16 greedy
    tokens.  Returns (the prefill's cache tensors, the first token, the
    tokens, the prefill's seconds, the ``ssd_scan`` launches).  The
    decode writes its tokens' K/V in place, past the prefill's length,
    where the ranks' decode writes them again before it reads them."""
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.models import build_model
    cfg = get(LONG_ARCH).replace(n_layers=LONG_LAYERS, use_kernels=True)
    model = build_model(cfg, device="cuda")
    params = model.init(model.generator(0))
    prompt = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, size=(1, LONG_PROMPT))).to("cuda")
    ssd.ssd_scan.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompt}, LONG_MAX)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = ssd.ssd_scan.launches
        first = torch.argmax(logits[:, -1], -1)[:, None]
        tensors = (cache.ssm.conv, cache.ssm.h, cache.k, cache.v,
                   cache.length)
        tok, toks, run = first, [], cache
        for _ in range(TENSOR_NEW):
            toks.append(tok)
            logits, run = model.decode_step(params, run, tok)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
    del params, logits, run
    gc.collect()
    torch.cuda.empty_cache()
    return (tensors, first, torch.cat(toks, 1).cpu().tolist(), prefill_s,
            launches)


def phase_fsdp_sp(card: str) -> dict:
    """[fsdp-sp]: FSDP storage and sequence parallelism on a (2, 2) mesh,
    the GQA decode fallback on (1, 8) and long-context decode on (2, 1),
    each against the same work in this process.  Returns the ranks' and
    this process's kernel launches."""
    import torch
    launches = {"flash_attention": 0, "ssd_scan": 0}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref, whole = _fsdp_reference()
    print(f"  one-process reference ({FSDP_ARCH} {FSDP_LAYERS} layers "
          f"{ref[FSDP_ARCH]['nparams']} params, {FSDP_SSM} "
          f"{ref[FSDP_SSM]['nparams']} params; {FSDP_STEPS} steps at "
          f"tokens ({FSDP_BATCH}, {FSDP_SEQ + 1})) "
          f"{time.perf_counter() - t0:.1f} s: losses "
          + "; ".join(f"{a} {[round(x, 6) for x in r['losses']]}"
                      for a, r in ref.items())
          + f"; {FSDP_ARCH} at ({FSDP_BATCH}, {FSDP_ODD + 1}) "
          f"{ref[FSDP_ARCH]['odd_loss']:.6f}")
    t0 = time.perf_counter()
    outs = _spawn(_fsdp_rank, 4, (whole,))
    del whole
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    for o in outs:
        r = o["rank"]
        for (arch, name), run in o["runs"].items():
            want = ref[arch]["losses"][:len(run["losses"])]
            rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], want)]
            check(max(rel) <= TENSOR_TOL,
                  f"fsdp-sp: rank {r} {arch} {name} losses "
                  f"{run['losses']} vs {want}")
            s1 = run["step1"]
            # a leaf's first and second moments within 1e-4 of the
            # one-process ones (max |d| / max |ref|), or, where that is
            # larger, within twice the leaf's noise of an f32 sum split in
            # two (the one-process microbatch step): mamba2's tied,
            # vocab-split embedding sits at ~1e-4
            noise = ref[arch]["noise"]
            over = [i for i, (e, f) in enumerate(zip(s1["mu_leaves"],
                                                     s1["nu_leaves"]))
                    if max(e, f) > max(TENSOR_TOL, 2 * noise[i])]
            check(not over and s1["param_excess"] <= 0.0,
                  f"fsdp-sp: rank {r} {arch} {name} step-1 shards "
                  f"{ {k: v for k, v in s1.items() if 'leaves' not in k} }, "
                  "leaves over (mu, nu, noise) "
                  f"{[(i, s1['mu_leaves'][i], s1['nu_leaves'][i], noise[i])
                      for i in over]}")
            gw, sp = FSDP_RUNS[name]
            check(run["sp"] == sp, f"fsdp-sp: rank {r} {arch} {name} "
                  f"sequence parallel {run['sp']}")
            check(abs(run["kernel_loss"] - run["plain_loss"]) < 1e-3,
                  f"fsdp-sp: rank {r} {arch} {name} kernel loss "
                  f"{run['kernel_loss']} vs plain {run['plain_loss']}")
            n = run["launches"]
            want_n = ({"flash_attention": FSDP_LAYERS, "ssd_scan": 0}
                      if arch == FSDP_ARCH else
                      {"flash_attention": 0,
                       "ssd_scan": _fsdp_cfgs()[arch].n_layers})
            check(n == want_n, f"fsdp-sp: rank {r} {arch} {name} launches "
                  f"{n}, expected {want_n}")
            for k in launches:
                launches[k] += n[k]
            base = o["runs"][arch, "baseline"]["bytes"]
            # FSDP storage: a leaf that spec_for splits on data holds half
            # of its baseline (2, 2) shard's bytes, parameters and moments
            # alike; every other leaf as many
            for k, got in run["bytes"].items():
                exp = [b // 2 if gw and s else b
                       for b, s in zip(base[k], run["split"])]
                check(got == exp, f"fsdp-sp: rank {r} {arch} {name} {k} "
                      f"bytes {sum(got)} vs {sum(exp)}")
            comm = ", ".join(f"{k}: {v:.3f} ms" for k, v in
                             sorted(run["comm_ms"].items()))
            total = {k: sum(v) for k, v in run["bytes"].items()}
            btot = {k: sum(v) for k, v in base.items()}
            print(f"  rank {r} ({o['backend']}) {arch} {name}: median step "
                  f"{1e3 * statistics.median(run['step_s']):.3f} ms "
                  f"({[round(1e3 * x, 3) for x in run['step_s']]}), losses "
                  f"{[round(x, 6) for x in run['losses']]} (max rel "
                  f"{max(rel):.2e}); step 1 mu / nu {s1['mu']:.2e} / "
                  f"{s1['nu']:.2e} (leaf {s1['mu_leaf']}, its noise floor "
                  f"{noise[s1['mu_leaf']]:.2e}), param excess "
                  f"{s1['param_excess']:.2e}; "
                  f"kernel loss {run['kernel_loss']:.6f} (plain "
                  f"{run['plain_loss']:.6f} on the rank's rows; {n}); bytes "
                  f"params {total['params']} mu {total['mu']} nu "
                  f"{total['nu']} (baseline {btot['params']} / {btot['mu']}"
                  f" / {btot['nu']}; {sum(run['split'])} leaves split on "
                  f"data); peak {run['peak_gb']:.2f} GB  [{FSDP_NOTE}; "
                  f"{card}]")
            print(f"  rank {r} {arch} {name}: fenced step's all-reduces "
                  f"(Gloo's CUDA gathers and scatters are all-reduces of "
                  f"padded shards) {comm}  [{FSDP_NOTE}; {card}]")
        check(not o["odd_sp"] and abs(o["odd_loss"]
                                      - ref[FSDP_ARCH]["odd_loss"])
              <= TENSOR_TOL * abs(ref[FSDP_ARCH]["odd_loss"]),
              f"fsdp-sp: rank {r} odd-length loss {o['odd_loss']} vs "
              f"{ref[FSDP_ARCH]['odd_loss']} (sequence parallel "
              f"{o['odd_sp']})")
        print(f"  rank {r}: seq_shard at {FSDP_ODD} inputs (not split: "
              f"the residual stream stays whole) loss {o['odd_loss']:.6f}"
              f" (one process {ref[FSDP_ARCH]['odd_loss']:.6f})")
    print(f"  (2, 2) ranks' wall {wall:.1f} s")
    # the GQA decode fallback on (1, 8)
    from repro_torch.configs import get
    from repro_torch.models import build_model
    import numpy as np
    t0 = time.perf_counter()
    cfg = get(FSDP_ARCH).replace(n_layers=FALLBACK_LAYERS)
    model = build_model(cfg, device="cuda")
    params = model.init(model.generator(0))
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(1, FALLBACK_PROMPT))).to("cuda")
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      FALLBACK_PROMPT + TENSOR_NEW)
        toks = []
        for _ in range(TENSOR_NEW):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks.append(tok)
            logits, cache = model.decode_step(params, cache, tok)
    want_tokens = torch.cat(toks, 1).cpu().tolist()
    want_k, want_v = cache.kv.k.cpu().numpy(), cache.kv.v.cpu().numpy()
    del params, cache, logits, model
    gc.collect()
    torch.cuda.empty_cache()
    outs = _spawn(_fallback_rank, FALLBACK_RANKS, ())
    for o in outs:
        r = o["rank"]
        check(o["rules"] == ("model", None), f"fsdp-sp: fallback rules "
              f"{o['rules']}")
        check(o["local"][2] == (FALLBACK_PROMPT + TENSOR_NEW)
              // FALLBACK_RANKS and o["local"][3] == cfg.n_kv_heads,
              f"fsdp-sp: fallback rank {r} cache {o['local']}")
        check(o["tokens"] == want_tokens, f"fsdp-sp: fallback rank {r} "
              f"tokens {o['tokens']} vs {want_tokens}")
        err = max(float(np.abs(o[k] - w).max()) / float(np.abs(w).max())
                  for k, w in (("k", want_k), ("v", want_v)))
        check(err <= TENSOR_TOL, f"fsdp-sp: fallback rank {r} cache "
              f"max|d|/max|ref| {err:.2e}")
        if r == 0:
            print(f"  (1, {FALLBACK_RANKS}) GQA fallback, {FSDP_ARCH} at "
                  f"full width and {FALLBACK_LAYERS} layers: cache "
                  f"{o['local']} a rank (every KV head, 1/{FALLBACK_RANKS} "
                  f"of {FALLBACK_PROMPT + TENSOR_NEW} positions); "
                  f"{TENSOR_NEW} greedy tokens equal; gathered cache "
                  f"max|d|/max|ref| {err:.2e}; median decode step "
                  f"{1e3 * statistics.median(o['decode_s']):.3f} ms; peak "
                  f"{o['peak_gb']:.2f} GB a rank  [{FSDP_NOTE}; {card}]")
    print(f"  (1, {FALLBACK_RANKS}) fallback wall "
          f"{time.perf_counter() - t0:.1f} s")
    # long context on (2, 1)
    t0 = time.perf_counter()
    tensors, first, want, prefill_s, n = _long_reference()
    launches["ssd_scan"] += n
    check(n == LONG_LAYERS, f"fsdp-sp: long prefill ssd_scan launches {n}")
    print(f"  {LONG_ARCH} {LONG_LAYERS} layers: {LONG_PROMPT}-token prefill "
          f"into a {LONG_MAX}-position cache {prefill_s:.1f} s in one "
          f"process ({n} ssd_scan launches)  [{card}]")
    outs = _spawn(_long_rank, 2, (tensors, first))
    del tensors
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    for o in outs:
        r = o["rank"]
        check(o["rules"] == ("pod", "data") and o["local"][2]
              == LONG_MAX // 2, f"fsdp-sp: long rank {r} rules "
              f"{o['rules']} cache {o['local']}")
        check(o["tokens"] == want, f"fsdp-sp: long rank {r} tokens "
              f"{o['tokens']} vs {want}")
        print(f"  (2, 1) long context rank {r}: cache {o['local']} (half of "
              f"{LONG_MAX} positions, the prompt past {LONG_MAX // 2}); "
              f"{TENSOR_NEW} greedy tokens equal; median decode step "
              f"{1e3 * statistics.median(o['decode_s']):.3f} ms; peak "
              f"{o['peak_gb']:.2f} GB  [{FSDP_NOTE}; {card}]")
    print(f"  (2, 1) long-context wall {time.perf_counter() - t0:.1f} s")
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
              f"at full width and {SCALE_LAYERS} of its layers, global "
              f"batch {SCALE_SHAPE[1]} x "
              f"{SCALE_SHAPE[0] + 1} tokens, {SCALE_STEPS} steps; {card}")
        ab_n, ns_n = phase_scaling(card)
        launches["ab_fused"] += ab_n
        launches["ns_fused"] += ns_n
        print(f"[scaling] phase wall time "
              f"{time.perf_counter() - t_scale:.1f} s  [{card}]")
        torch.cuda.empty_cache()
        t_tensor = time.perf_counter()
        print(f"[tensor] tensor parallelism on a (1, 2) mesh: "
              f"{TENSOR_ARCH} at full width, {TENSOR_LAYERS} of its layers, "
              f"{TENSOR_MOE} at {TENSOR_MOE_LAYERS} of its layers; "
              f"{TENSOR_NOTE}; {card}")
        launches["flash_attention"] += phase_tensor(card)
        print(f"[tensor] phase wall time "
              f"{time.perf_counter() - t_tensor:.1f} s  [{TENSOR_NOTE}; "
              f"{card}]")
        torch.cuda.empty_cache()
        t_tssm = time.perf_counter()
        print(f"[tensor-ssm] tensor parallelism of the SSM, hybrid and "
              f"encoder-decoder families on a (1, 2) mesh: {TSSM[0]} and "
              f"{TSSM[1]} at full width and depth, {TSSM[2]} at full width; "
              f"{TENSOR_NOTE}; {card}")
        for n, c in phase_tensor_ssm(card).items():
            launches[n] += c
        print(f"[tensor-ssm] phase wall time "
              f"{time.perf_counter() - t_tssm:.1f} s  [{TENSOR_NOTE}; "
              f"{card}]")
        torch.cuda.empty_cache()
        t_fsdp = time.perf_counter()
        print(f"[fsdp-sp] FSDP storage and sequence parallelism on a (2, 2) "
              f"mesh: {FSDP_ARCH} at full width, {FSDP_LAYERS} of its "
              f"layers, {FSDP_SSM} at full size; the GQA decode fallback on "
              f"(1, {FALLBACK_RANKS}) at {FALLBACK_LAYERS} layers; "
              f"{LONG_ARCH} long-context decode on "
              f"(2, 1); {FSDP_NOTE}; {card}")
        for n, c in phase_fsdp_sp(card).items():
            launches[n] += c
        print(f"[fsdp-sp] phase wall time "
              f"{time.perf_counter() - t_fsdp:.1f} s  [{FSDP_NOTE}; {card}]")
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

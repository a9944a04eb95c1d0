"""The training cell: the program's own ``Trainer.train`` with graph-
guided profiling on (``RunConfig.scalana``), driven through its step
loop, data hand-off and profiler hook.

Set-up (``setup_s``): the Trainer, the weights made on the card from the
seed and handed to it as its state, the token batches from the seed in a
data set whose ``batch(i)`` the Trainer reads, ``enable_scalana``'s
trace of the step into the PSG, and warm-up: whole sampling periods
(``sample_every`` steps, the last of each through the traced graph).
The warm-up's first ``checked_steps`` are the steps the reference
follows; reading their gradients and parameters for the judge is left
out of ``setup_s``.

The window is one ``Trainer.train(num_steps=N)`` call, N a whole number
of sampling periods chosen from the warm-up's step times to last about
``--seconds``.  With ``--trace 1`` its last period runs under
``torch.profiler`` in a call of its own.

After the window the judge holds the program against the plain
reference: the losses of the checked steps and of the window's first
``window_checked`` steps, the first step's gradients (from the
optimizer's first moment) and the parameters' change over the checked
steps; and the profiler's product: every top-level vertex's samples,
each sampled step's vertex times against the benchmark's own clock on
that step (:class:`StepClock`) and each vertex's least time against a
plain measure of further steps (:mod:`chipbench.reference.vertex_times`),
a replay across processes with an injected straggler, ``detect_abnormal`` on the card against a plain
copy, and the backtrack to the straggler.

``run`` takes a Trainer whose trace is made already (``prepare``), so
that ``chipbench/control.py`` reads a dozen seeds in one process."""
from __future__ import annotations

import gc
import inspect
import math
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from chipbench.flops.count import train_step_flops
from chipbench.harness import registry, weights
from chipbench.harness.tokens import TokenBatches
from chipbench.reference import judge, train as ref_train, vertex_times
from chipbench.reference.detect import abnormal_pairs


def _log(msg: str) -> None:
    print(f"chipbench: {msg}", file=sys.stderr, flush=True)


def _check_optimizer(opt: Dict) -> None:
    """The traffic states the optimizer's constants; the program's AdamW
    has to run with them (it takes b1, b2, eps and the clip norm from its
    own defaults), or the run is not of this configuration."""
    from repro_torch.optim.adamw import adamw_update
    sig = inspect.signature(adamw_update).parameters
    for key in ("b1", "b2", "eps", "max_grad_norm"):
        if sig[key].default != opt[key]:
            raise RuntimeError(f"the program's AdamW has {key}="
                               f"{sig[key].default}, the traffic states "
                               f"{opt[key]}")
    if opt["schedule"] != "warmup_cosine" or opt["final_frac"] != 0.1:
        raise RuntimeError("the program's Trainer runs warmup_cosine with "
                           "final_frac 0.1")


def _trainer(cell: Dict, device, mesh=None):
    from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
    from repro_torch.training.trainer import Trainer
    cfg, traffic = cell["config"], cell["traffic"]
    opt = traffic["optimizer"]
    arch = ArchConfig(**cfg["arch"])
    run = RunConfig(arch=cfg["name"], learning_rate=opt["learning_rate"],
                    weight_decay=opt["weight_decay"],
                    warmup_steps=opt["warmup_steps"],
                    total_steps=opt["total_steps"], scalana=True,
                    scalana_sample_every=traffic["sample_every"],
                    checkpoint_dir="")
    world = cell.get("world", 1)
    shape = ShapeConfig("chipbench", traffic["seq_len"],
                        traffic["batch"] * world, "train")
    return Trainer(run, mesh=mesh, arch_cfg=arch, shape=shape,
                   device=device)


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _fence(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepClock:
    """The benchmark's own clock on the Trainer's steps, through the data
    set that the Trainer reads: the host clock at each ``batch(i)`` call,
    with the profiler's count of sampled steps and its time of each
    vertex over them at that moment.  A step runs from its batch's call
    to the next; a call's last step to the benchmark's own fence after
    it."""

    def __init__(self, data: TokenBatches, profiler):
        self.data, self.profiler = data, profiler
        self.calls: List[Tuple[bool, List]] = []
        self._seen, self._totals = -1, {}

    def batch(self, i: int):
        self._mark()
        return self.data.batch(i)

    def _mark(self) -> None:
        t = time.perf_counter()
        n = self.profiler.sampled_steps
        if n != self._seen:
            self._seen = n
            self._totals = {v: p.time * p.samples for v, p in
                            self.profiler.perf_vectors().items()}
        self.calls[-1][1].append((t, n, self._totals))

    def train(self, trainer, num_steps: int, state: List, device,
              traced: bool = False) -> float:
        """One ``Trainer.train`` call on the clock, from and back into the
        one-item list ``state`` (no other reference keeps the state the
        call starts from alive); its seconds by the host clock."""
        self.calls.append((traced, []))
        t0 = time.perf_counter()
        state.append(trainer.train(num_steps=num_steps, state=state.pop(),
                                   resume=False))
        seconds = time.perf_counter() - t0
        _fence(device)
        self._mark()
        return seconds

    def sampled(self):
        """(traced, span, the vertices' times) of each sampled step."""
        for traced, marks in self.calls:
            for a, b in zip(marks, marks[1:]):
                if b[1] > a[1]:
                    yield traced, b[0] - a[0], {
                        v: t - a[2].get(v, 0.0) for v, t in b[2].items()
                        if t != a[2].get(v, 0.0)}

    def vertex_times(self) -> Dict[int, float]:
        """Each vertex's least time over the sampled steps of the calls
        that ran outside ``torch.profiler`` (of all, if none did): a
        pause of the host's lengthens one step's vertex, never shortens
        one."""
        steps = list(self.sampled())
        use = [s[2] for s in steps if not s[0]] or [s[2] for s in steps]
        names = set().union(*use) if use else set()
        return {v: min(times.get(v, 0.0) for times in use) for v in names}

    def over(self) -> float:
        """The most by which a sampled step's vertex times together
        exceed its step's span, as a share of it (sound: they lie inside
        it); NaN without a sampled step."""
        return _worst([(sum(times.values()) - span) / span
                       for _, span, times in self.sampled()])


def _worst(values: List[float]) -> float:
    """The largest value; NaN if there is none or any is NaN."""
    if not values or any(v != v for v in values):
        return math.nan
    return max(values)


def followed_steps(traffic: Dict) -> int:
    """The steps the reference follows: the checked steps of the warm-up
    and the window's first ``window_checked``, which follow them
    without a gap."""
    checked = traffic["checked_steps"]
    extra = traffic.get("window_checked", 0)
    warm = traffic["warmup_periods"] * traffic["sample_every"]
    if not 1 <= checked <= warm or (extra and checked != warm):
        raise ValueError("checked_steps must lie within the warm-up, and "
                         "fill it where window_checked is set")
    return checked + extra


def reference_batches(traffic: Dict, vocab: int, seed: int, rows: int,
                      device) -> List[torch.Tensor]:
    data = TokenBatches(traffic, vocab, seed, rows)
    return [torch.from_numpy(data.tokens(i)).to(device=device,
                                                 dtype=torch.long)
            for i in range(followed_steps(traffic))]


def _leaf_norms(tree: Dict, scale: float = 1.0) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t)) * scale
            for n, t in ref_train.flatten(tree)}


def _change_norms(params: Dict, specs: Dict, seed: int, device) -> Dict:
    start = ref_train.flatten(weights.make(specs, seed, device))
    out = {n: float(torch.linalg.vector_norm(p - p0))
           for (n, p), (_, p0) in zip(ref_train.flatten(params), start)}
    del start
    return out


def _allocator(device) -> str:
    if device.type != "cuda":
        return "no allocator counts"
    st = torch.cuda.memory_stats(device)
    return ("allocator: retries {}, device allocs {}, frees {}".format(
        st.get("num_alloc_retries"), st.get("num_device_alloc"),
        st.get("num_device_free")))


def _period_steps(walls: List[float], k: int) -> float:
    """One sampling period's seconds from the warm-up's steps: the median
    fast step times k - 1, plus the last sampled step."""
    fast = [t for i, t in enumerate(walls, 1) if i % k and i > 1] or walls
    return statistics.median(fast) * (k - 1) + walls[-1]


def _window(trainer, state: List, clock: StepClock, n: int, k: int,
            traced: bool, device, measure):
    """The measured window: ``n`` steps in one ``Trainer.train`` call;
    traced, its last period in a call of its own under the profiler,
    with ``measure()`` run before the profiler starts (the card runs
    slower for a while after it).  Returns
    (seconds of the calls, the trace's reduction or None, what
    ``measure`` gave or None)."""
    if not traced:
        return clock.train(trainer, n, state, device), None, None
    from torch.profiler import ProfilerActivity, profile, record_function
    from chipbench.harness import devtrace
    window_s = 0.0
    if n > k:
        window_s = clock.train(trainer, n - k, state, device)
        clock.data.offset += n - k
    measured = measure()
    # the profiler's start and stop stay out of the window's time
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW):
            window_s += clock.train(trainer, k, state, device,
                                    traced=True)
    t = time.perf_counter()
    trace = devtrace.reduce(prof.profiler.kineto_results.events())
    _log(f"trace read in {time.perf_counter() - t:.1f} s")
    if trace is not None:
        trace["steps"] = k
    return window_s, trace, measured


def _state(specs, seed: int, device):
    from repro_torch.optim import adamw_init
    from repro_torch.training.trainer import TrainState
    w0 = weights.make(specs, seed, device)
    return TrainState(params=w0, opt=adamw_init(w0), residual=None,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def prepare(cell: Dict, mesh=None, trainer=None, state=None):
    """A Trainer (``trainer``, or a new one) with the step traced into its
    PSG (``enable_scalana``) on ``state``, or on weights of the cell's
    seed made for it and freed after: the trace depends on the shapes
    alone, so a Trainer made here serves any seed."""
    from repro_torch.training.trainer import to_device
    device = torch.device(cell["device"])
    trainer = trainer or _trainer(cell, device, mesh)
    traffic = cell["traffic"]
    data = TokenBatches(traffic, cell["config"]["arch"]["vocab_size"],
                        cell["seed"], traffic["batch"])
    own = state is None
    if own:
        state = _state(trainer.model.specs, cell["seed"], device)
    t = time.perf_counter()
    trainer.enable_scalana(state, to_device(data.batch(0), device))
    _log(f"trace {time.perf_counter() - t:.1f} s, PSG "
         f"{len(trainer.profiler.psg.vertices)} vertices")
    if own:
        del state
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return trainer


def run(cell: Dict, rank: int = 0, world: int = 1, mesh=None,
        trainer=None) -> Optional[Dict]:
    """One run of the cell; the record the metric readers read (rank 0),
    or None on the other ranks.  ``trainer``: one from ``prepare``, which
    may have run other seeds before."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the configuration
    torch.backends.cudnn.allow_tf32 = False           # is float32
    device = torch.device(cell["device"])
    cfg, traffic, seed = cell["config"], cell["traffic"], cell["seed"]
    opt, k = traffic["optimizer"], traffic["sample_every"]
    checked = traffic["checked_steps"]
    warm = traffic["warmup_periods"] * k
    followed = followed_steps(traffic)
    _check_optimizer(opt)
    judge_s = 0.0

    if trainer is None:
        trainer = _trainer(cell, device, mesh)
        state = [_state(trainer.model.specs, seed, device)]
        prepare(cell, mesh, trainer, state[0])
    else:
        state = [_state(trainer.model.specs, seed, device)]
    rows = traffic["batch"]
    data = TokenBatches(traffic, cfg["arch"]["vocab_size"], seed, rows,
                        row0=rank * rows, global_rows=rows * world)
    trainer.dataset = data
    base = len(trainer.step_wall_times)         # steps of earlier seeds
    specs = trainer.model.specs

    # warm-up: step 1 alone (its moments give the first gradient), then
    # the rest of the warm-up periods
    state.append(trainer.train(num_steps=1, state=state.pop(),
                               resume=False))
    t = time.perf_counter()
    grad_norms = _leaf_norms(state[0].opt.mu, 1.0 / (1.0 - opt["b1"]))
    judge_s += time.perf_counter() - t
    if checked > 1:
        data.offset = 1
        state.append(trainer.train(num_steps=checked - 1,
                                   state=state.pop(), resume=False))
    t = time.perf_counter()
    change_norms = _change_norms(state[0].params, specs, seed, device)
    judge_s += time.perf_counter() - t
    if warm > checked:
        data.offset = checked
        state.append(trainer.train(num_steps=warm - checked,
                                   state=state.pop(), resume=False))
    _fence(device)
    walls = trainer.step_wall_times[base:]
    periods = max(1, round(cell["seconds"] / _period_steps(walls, k)))
    n = periods * k
    if n < followed - warm:
        raise ValueError("the window is shorter than window_checked")
    setup_s = time.perf_counter() - cell["t_start"] - judge_s
    _log(f"set-up {setup_s:.1f} s; warm-up steps "
         + " ".join(f"{w:.3f}" for w in walls) + f"; window {n} steps; "
         + _allocator(device))

    # the window
    from chipbench.harness.smi import Smi
    smi = Smi()
    data.offset = warm
    clock = StepClock(data, trainer.profiler)
    trainer.dataset = clock
    before, pbefore = len(trainer.step_wall_times), \
        len(trainer.profiler.step_times)
    # the plain measure of the vertices' times: further steps of the
    # traced graph on the program's state (every rank: it may all-reduce)
    measure_s, peaks = [], []

    def measure():
        """The measure, its seconds and the memory peak before it kept
        aside: its steps are no part of the window."""
        peaks.append(_peak(device))
        t = time.perf_counter()
        out = _measured_vertex_times(trainer, state[0], data, device)
        measure_s.append(time.perf_counter() - t)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        return out
    smi.start()
    try:
        window_s, trace, measured = _window(trainer, state, clock, n, k,
                                            cell["trace"], device, measure)
    finally:
        smi_summary = smi.stop()
    peak = max([_peak(device)] + peaks)
    if measured is None:
        measured = measure()
    step_wall = trainer.step_wall_times[before:]
    prof_steps = trainer.profiler.step_times[pbefore:]
    _log(f"window {window_s:.3f} s; steps "
         + " ".join(f"{w:.3f}" for w in step_wall) + "; profiled "
         + " ".join(f"{w:.3f}" for w in prof_steps) + f"; peak {peak} B; "
         + _allocator(device))
    losses = [m["loss"] for m in trainer.metrics_log[base:]
              if "loss" in m]
    window_losses = losses[warm:]
    prog_losses = losses[:checked] + window_losses[:followed - checked]
    if rank:
        return None

    # the profiler's product
    numbers = _profiler_numbers(trainer, traffic,
                                len(trainer.step_wall_times) // k, device)
    recorded = clock.vertex_times()
    numbers["vertex_time_short"] = vertex_times.shortfall(recorded,
                                                          measured)
    numbers["vertex_time_over"] = clock.over()
    _log("vertex times (ms) recorded / measured: " + " ".join(
        f"{v}:{1e3 * recorded.get(v, 0.0):.3f}/{1e3 * m:.3f}"
        for v, m in sorted(measured.items())))

    # the reference, once the program's state is freed
    del state, trainer, clock
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    batches = reference_batches(traffic, cfg["arch"]["vocab_size"], seed,
                                rows * world, device)
    ref = ref_train.follow(lambda: weights.make(specs, seed, device),
                           batches, cfg, opt, "f32", change_at=checked)
    ref_s = time.perf_counter() - t
    keep = ref_train.kept_leaves(ref["grad_norms"])
    numbers.update({
        "loss_gap": judge.loss_gap(prog_losses, ref["losses"]),
        "grad_gap": judge.leaf_gap(grad_norms, ref["grad_norms"], keep),
        "change_gap": judge.leaf_gap(change_norms, ref["change_norms"],
                                     keep),
    })
    _log(f"reference {ref_s:.1f} s; losses program "
         + " ".join(f"{x:.7f}" for x in prog_losses) + " reference "
         + " ".join(f"{x:.7f}" for x in ref["losses"])
         + f"; {len(ref['grad_norms']) - len(keep)} leaves left out; "
         + "vertex times short {vertex_time_short:.5f} over "
           "{vertex_time_over:.5f}".format(**numbers)
         + f"; vertices measured in {measure_s[0]:.1f} s")
    limits = cell.get("limits") or registry.limits(cell["workload"])
    flops_step = train_step_flops(cfg["arch"], rows * world,
                                  traffic["seq_len"])
    failed = sum(1 for x in window_losses if not math.isfinite(x))
    return {
        "correct": judge.verdict(numbers, limits) and failed == 0,
        "checks": {k2: {"value": numbers.get(k2), "limit": lim}
                   for k2, lim in limits.items()},
        "numbers": numbers,
        "attempted": n, "failed": failed,
        "setup_s": setup_s, "window_s": window_s, "steps": n,
        "tokens": n * rows * world * traffic["seq_len"],
        "flops": n * flops_step, "flops_per_step": flops_step,
        "step_wall_s": step_wall, "profiler_step_s": prof_steps,
        "sampled": [(warm + j) % k == 0 for j in range(1, n + 1)],
        "memory_peak_bytes": peak, "trace": trace, "smi": smi_summary,
        "reference_s": ref_s,
    }


def _measured_vertex_times(trainer, state, data: TokenBatches,
                           device) -> Dict[int, float]:
    """The plain measure (:mod:`chipbench.reference.vertex_times`) of
    steps of the profiler's traced graph: the program's graph, vertices
    and state, timed by the benchmark's own code."""
    from repro_torch.training.trainer import to_device
    prof = trainer.profiler
    root = prof.psg.root
    vertex_of = {n: prof.mapping.get(vid, root)
                 for n, vid in prof.traced.top_vertex.items()}
    flat = prof.traced.flat_args(state, to_device(data.batch(0), device))
    return vertex_times.vertex_times(prof.traced.graph_module, vertex_of,
                                     flat, device)


def _profiler_numbers(trainer, traffic: Dict, samples: int,
                      device) -> Dict[str, float]:
    """The profiler's product judged: samples on every top-level vertex;
    the replay of ``procs`` processes with one slowed at the first loop;
    the abnormal vertices on the card against the plain rule; the
    backtrack's root causes."""
    from repro_torch.core import backtrack, detect_abnormal, root_causes
    from repro_torch.core.inject import schedule, simulate
    prof = trainer.profiler
    psg = prof.psg
    tops = list(psg.children(psg.root))
    pv = prof.perf_vectors()
    missing = sum(1 for v in tops if v not in pv or pv[v].samples != samples)
    st = traffic["straggler"]
    target = next(v for v in schedule(psg)
                  if psg.vertices[v].kind == "Loop"
                  and psg.vertices[v].parent == psg.root)
    base = {v: pv[v].time if v in pv else 0.0 for v in tops}
    delay = st["delay_frac"] * base[target]
    proc = st["proc"]
    res = simulate(psg, st["procs"], prof.base_times(),
                   inject={(proc, target): delay})
    t = res.ppg.times_matrix()
    # a replayed computation takes its profiled time on every process,
    # the straggler's slowed one its delay more (a collective's time
    # holds the wait for the straggler, so it is not held here)
    comp = [v for v in tops if psg.vertices[v].kind != "Comm"]
    expect = np.tile(np.array([base[v] for v in comp]), (st["procs"], 1))
    expect[proc, comp.index(target)] += delay
    replay_bad = int(np.sum(~np.isclose(t[:, comp], expect, rtol=1e-12,
                                        atol=0.0)))
    ab = detect_abnormal(res.ppg, abnorm_thd=st["abnorm_thd"],
                         backend="torch", device=device)
    got = [(a.vid, a.proc) for a in ab]
    want = abnormal_pairs(t, tops, st["abnorm_thd"], 0.01, 20)
    ab_bad = 0 if got == want else max(1, len(set(got) ^ set(want)))
    paths = backtrack(res.ppg, [], ab)
    found = any(node == (proc, target)
                for node, _, _ in root_causes(paths, psg, ppg=res.ppg))
    _log(f"profiler: {len(tops)} top-level vertices, {samples} samples "
         f"each expected; straggler p{proc} at vertex {target} "
         f"({psg.vertices[target].name}) +{delay * 1e3:.3f} ms; "
         f"abnormal {got[:4]}")
    return {"vertex_samples_missing": float(missing),
            "replay_mismatch": float(replay_bad),
            "abnormal_mismatch": float(ab_bad),
            "root_cause_missed": 0.0 if found else 1.0}

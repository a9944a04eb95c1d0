"""Dependence-driven performance simulation + delay injection.

Reproduces the paper's evaluation methodology (§II motivating example: a
delay injected into process 4 of NPB-CG propagates through communication
dependence until an MPI_Allreduce exposes it as scaling loss).  Given a PSG
with Comm vertices, per-vertex base times, and injected per-(process,vertex)
delays, the simulator executes the dependence graph: processes advance
clocks through Comp vertices, block at p2p edges until the partner arrives
and at collectives until the whole replica group arrives.  Waiting time is
recorded in the 'wait_s' counter — exactly the signal Algorithm 1's pruning
keys on.

The replay engine is array-level end to end:

* ``base_times`` is a vectorized channel — ``fn(procs_array, vid) ->
  per-process seconds`` — so a Comp vertex costs O(1) Python calls, not
  O(P).  Scalar callables (``fn(proc, vid) -> float``) are auto-detected
  and shimmed (see :class:`_BaseTimes` / :func:`vectorized_base_times`).
* p2p pairs are decomposed into *wavefront rounds* (:func:`p2p_rounds`):
  a greedy topological coloring of the pair list in which no process
  appears twice per round, so each round is one numpy gather/scatter
  clock update plus one batched ``PerfStore.set_entries`` write while
  bit-matching the order-dependent sequential semantics.  The per-pair
  reference implementation is retained (``p2p="sequential"``) as the
  property-test oracle; the default ``"auto"`` falls back to it for
  degenerate chains where rounds cannot batch.
* :func:`simulate_series` is a single stacked pass: the per-scale clocks
  form an (S, P_max) masked matrix advanced once per scheduled vertex for
  all scales simultaneously, writing into per-scale PerfStores — the
  vertex schedule is walked exactly once for the whole series.

The same machinery generates multi-scale series for non-scalable-vertex
detection, with per-vertex scaling laws (ideal 1/p compute, logarithmic
collectives, serial fractions, ...).  Measured single-scale profiles from
GraphProfiler can seed ``base_times`` (:func:`seeded_base_times`,
``GraphProfiler.base_times``) so case studies run on real models.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import (BRANCH, CALL, COMM, COMP, LOOP, PPG, PSG,
                                    PerfStore, PerfVector, pairs_array,
                                    vertex_pairs_array)
from repro_torch.core.ppg import build_ppg
from repro_torch.core.shard import ShardedStore, shard_ranges

# default comm model constants (tunable; roughly ICI-like)
LATENCY_S = 1e-6
BANDWIDTH = 50e9

P2P_MODES = ("auto", "wavefront", "sequential")


def _subtree_has_comm(psg: PSG, vid: int, cache: Dict[int, bool]) -> bool:
    if vid in cache:
        return cache[vid]
    v = psg.vertices[vid]
    r = v.kind == COMM or any(_subtree_has_comm(psg, c, cache)
                              for c in psg.children(vid))
    cache[vid] = r
    return r


def schedule(psg: PSG) -> List[int]:
    """Flattened execution schedule: control structures containing comm are
    expanded so communication ordering is visible; others are atomic."""
    cache: Dict[int, bool] = {}
    out: List[int] = []

    def walk(vid: int):
        for c in psg.children(vid):
            v = psg.vertices[c]
            if v.kind in (LOOP, BRANCH, CALL) and _subtree_has_comm(psg, c,
                                                                    cache):
                walk(c)
            else:
                out.append(c)

    walk(psg.root)
    return out


def default_comm_time(v, n_procs: int, group: Sequence[int]) -> float:
    g = max(len(group), 2)
    steps = max(int(np.ceil(np.log2(g))), 1)
    return LATENCY_S * steps + float(v.comm_bytes) / BANDWIDTH


@dataclasses.dataclass
class SimResult:
    ppg: PPG
    clocks: List[float]                    # final per-process time
    sched: List[int]

    @property
    def makespan(self) -> float:
        return max(self.clocks) if self.clocks else 0.0

    @property
    def shards(self):
        """Per-host PerfShard blocks when the replay ran sharded
        (``simulate(..., shards=...)``), else None."""
        return getattr(self.ppg.perf, "shards", None)


# ---------------------------------------------------------------------------
# base_times channel: vectorized contract + scalar-callable shim
# ---------------------------------------------------------------------------

def vectorized_base_times(fn):
    """Mark ``fn`` as vectorized: ``fn(procs_array, vid) -> seconds`` where
    the result broadcasts to ``procs_array.shape``.  Skips the shim's
    auto-detection probe (set ``fn.scalana_vectorized = False`` to force
    the scalar per-process loop instead)."""
    fn.scalana_vectorized = True
    return fn


def seeded_base_times(times, n_vertices: Optional[int] = None) -> Callable:
    """Vectorized ``base_times`` from a per-vertex time table.

    ``times`` is a ``{vid: seconds}`` mapping (e.g. from
    ``GraphProfiler.perf_vectors()``) or a dense per-vertex array; vertices
    outside the table replay at 0.0 seconds.
    """
    if isinstance(times, Mapping):
        n = (max(times, default=-1) + 1) if n_vertices is None else n_vertices
        table = np.zeros(max(int(n), 0))
        for vid, t in times.items():
            if 0 <= vid < table.size:
                table[vid] = t
    else:
        table = np.asarray(times, float)

    @vectorized_base_times
    def base(procs, vid):
        return float(table[vid]) if 0 <= vid < table.size else 0.0

    return base


class _BaseTimes:
    """Resolved per-process base-times channel for one scale.

    The public contract is vectorized — ``fn(procs_array, vid)`` returns
    per-process seconds broadcastable to ``(n_procs,)`` — which turns the
    former O(P·V) Python callbacks into O(V) array calls.  Scalar
    callables (``fn(proc, vid) -> float``) are auto-detected on the first
    vertex: elementwise bodies that happen to accept arrays are used
    vectorized directly; bodies that raise on arrays (e.g. ``if p == 2``)
    fall back to a per-process loop.  A ``scalana_vectorized`` attribute
    (see :func:`vectorized_base_times`) skips the probe.
    """

    __slots__ = ("fn", "n", "procs", "mode")

    def __init__(self, fn: Callable, n_procs: int):
        self.fn = fn
        self.n = int(n_procs)
        self.procs = np.arange(self.n)
        flag = getattr(fn, "scalana_vectorized", None)
        self.mode = ("vector" if flag
                     else "scalar" if flag is False else "auto")

    def _vector(self, vid: int) -> np.ndarray:
        out = np.asarray(self.fn(self.procs, vid), float)
        return np.array(np.broadcast_to(out, (self.n,)), float)

    def _scalar(self, vid: int) -> np.ndarray:
        return np.fromiter((self.fn(p, vid) for p in range(self.n)),
                           float, count=self.n)

    def __call__(self, vid: int) -> np.ndarray:
        if self.mode == "scalar":
            return self._scalar(vid)
        if self.mode == "vector":
            return self._vector(vid)
        # auto: try vectorized; a body that rejects arrays (possibly only
        # on some vertices — branches like ``if p == 2``) demotes the
        # callable to the scalar loop for the rest of the replay
        try:
            return self._vector(vid)
        except Exception:
            self.mode = "scalar"
            return self._scalar(vid)


# ---------------------------------------------------------------------------
# wavefront decomposition of ordered p2p pair lists
# ---------------------------------------------------------------------------

def _p2p_rounds_greedy(pairs: Sequence[Tuple[int, int]], n_procs: int
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Scalar reference for :func:`p2p_rounds`: greedy next-free-round
    assignment over the pair list (the property tests pin peel == greedy).
    """
    next_round: Dict[int, int] = {}
    rounds: List[Tuple[List[int], List[int]]] = []
    for s, d in pairs:
        if s >= n_procs or d >= n_procs:
            continue
        r = max(next_round.get(s, 0), next_round.get(d, 0))
        if r == len(rounds):
            rounds.append(([], []))
        rounds[r][0].append(s)
        rounds[r][1].append(d)
        next_round[s] = next_round[d] = r + 1
    return [(np.asarray(sa, np.intp), np.asarray(da, np.intp))
            for sa, da in rounds]


def p2p_rounds(pairs: Sequence[Tuple[int, int]], n_procs: int,
               bail: bool = False
               ) -> Optional[List[Tuple[np.ndarray, np.ndarray]]]:
    """Decompose an ordered p2p pair list into wavefront rounds.

    Topological coloring over the sender/receiver multigraph: each pair
    lands in the earliest round strictly after every earlier pair it
    shares a process with.  Within a round no process appears twice (a
    self-pair ``(p, p)`` occupies ``p`` once in both roles), so the
    per-pair clock updates commute and a round executes as one numpy
    gather/scatter; replaying rounds in order bit-matches the sequential
    per-pair semantics.  Pairs touching processes ``>= n_procs`` are
    dropped, consistent with the simulator.

    Computed by vectorized peeling — each iteration selects every pair
    that is the first remaining pair for BOTH its processes (identical
    rounds to the greedy scalar scan, which layers the same
    immediate-predecessor-per-process DAG).  ``bail=True`` returns None
    as soon as a round batches poorly (a degenerate chain like a ring in
    natural order colors one pair per round — O(pairs) rounds — where the
    per-pair reference loop is the better executor).  Returns a
    ``(senders, receivers)`` index-array tuple per round.
    """
    if not len(pairs):
        return []
    arr = pairs_array(pairs)
    keep = (arr[:, 0] < n_procs) & (arr[:, 1] < n_procs)
    s, d = arr[keep, 0], arr[keep, 1]
    order = np.arange(s.size)
    sentinel = s.size                   # > any original pair index
    rounds: List[Tuple[np.ndarray, np.ndarray]] = []
    first = np.empty(n_procs, np.intp)
    while s.size:
        first[:] = sentinel
        np.minimum.at(first, s, order)
        np.minimum.at(first, d, order)
        sel = (first[s] == order) & (first[d] == order)
        if bail and s.size > 64 and 8 * int(sel.sum()) < s.size:
            return None
        rounds.append((s[sel], d[sel]))
        rest = ~sel
        s, d, order = s[rest], d[rest], order[rest]
    return rounds


# ---------------------------------------------------------------------------
# the replay engine: per-scale lanes over one stacked clock matrix
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Lane:
    """Per-scale replay state — one row of the stacked (S, P_max) clock
    matrix plus that scale's store / rng / injection table."""
    n: int
    base: _BaseTimes
    store: PerfStore
    rng: np.random.Generator
    inj: Dict[int, Dict[int, float]]
    clocks: np.ndarray                 # length-P_max row view; [n:] masked


def _inject_by_vid(inject: Optional[Mapping[Tuple[int, int], float]],
                   n_procs: int) -> Dict[int, Dict[int, float]]:
    out: Dict[int, Dict[int, float]] = {}
    for (p, vid), extra in (inject or {}).items():
        if p < n_procs:
            out.setdefault(vid, {})[p] = extra
    return out


def _p2p_wavefront(lane: _Lane, v, vid: int, tc: float,
                   rounds: List[Tuple[np.ndarray, np.ndarray]]) -> None:
    """One gather/scatter clock update + one batched store write per round."""
    clocks, store = lane.clocks, lane.store
    for sa, da in rounds:
        cs = clocks[sa]                              # fancy index: copies
        cd = clocks[da]
        wait = np.maximum(cs - cd, 0.0)
        procs = np.concatenate([da, sa])             # receiver adds first
        times = np.concatenate([wait + tc, np.full(sa.size, tc)])
        waits = np.concatenate([wait, np.zeros(sa.size)])
        store.set_entries(procs, vid, times,
                          counters={"wait_s": waits,
                                    "comm_bytes": v.comm_bytes},
                          accumulate=True)
        clocks[da] = np.maximum(cd, cs) + tc
        clocks[sa] = cs + tc


def _p2p_sequential(lane: _Lane, v, vid: int, tc: float) -> None:
    """Retained per-pair reference implementation (the property-test
    oracle, and the faster path for degenerate chains where rounds cannot
    batch).  Entries accumulate: a process participating in several pairs
    records its TOTAL time at the vertex (each receive adds wait + tc,
    each send adds tc), matching its clock advance."""
    clocks, store = lane.clocks, lane.store
    for s, d in v.p2p_pairs:
        if s >= lane.n or d >= lane.n:
            continue
        cs, cd = float(clocks[s]), float(clocks[d])
        wait = max(0.0, cs - cd)
        store.set_entry(d, vid, wait + tc,
                        counters={"wait_s": wait,
                                  "comm_bytes": v.comm_bytes},
                        accumulate=True)
        store.set_entry(s, vid, tc,
                        counters={"wait_s": 0.0,
                                  "comm_bytes": v.comm_bytes},
                        accumulate=True)
        clocks[d] = max(cd, cs) + tc
        clocks[s] = cs + tc


def _collective(lane: _Lane, v, vid: int, comm_time: Callable) -> None:
    """Per-lane reference for :func:`_collective_stacked` (property-tested
    bit-identical; the replay engine itself runs the stacked path)."""
    clocks = lane.clocks
    groups = v.meta.get("replica_groups") or [list(range(lane.n))]
    for g in groups:
        gi = np.asarray([p for p in g if p < lane.n], int)
        if gi.size == 0:
            continue
        tc = comm_time(v, lane.n, gi.tolist())
        sync = float(clocks[gi].max())
        wait = sync - clocks[gi]
        lane.store.set_column(vid, wait + tc, procs=gi,
                              counters={"wait_s": wait,
                                        "comm_bytes": v.comm_bytes})
        clocks[gi] = sync + tc


def _collective_stacked(lanes: List[_Lane], clocks: np.ndarray, v, vid: int,
                        comm_time: Callable) -> None:
    """Advance EVERY scale through one collective leg together.

    Per replica group, the synchronization point of all S scales is one
    cross-scale masked max over the stacked (S, P_max) clock matrix —
    previously one masked row reduction per scale.  Store writes and the
    per-lane ``comm_time`` stay per scale (tc depends on the lane's clipped
    group); results are bit-identical to :func:`_collective` per lane.
    """
    S, P_max = clocks.shape
    groups = v.meta.get("replica_groups")
    for g in (groups if groups else [None]):
        member = np.zeros((S, P_max), bool)
        gis: List[np.ndarray] = []
        for si, lane in enumerate(lanes):
            if g is None:
                gi = np.arange(lane.n, dtype=np.intp)
            else:
                garr = np.asarray(g, np.intp)
                gi = garr[garr < lane.n]          # keeps the group's order
            gis.append(gi)
            member[si, gi] = True
        # ONE matrix op for all S scales (the former per-scale row max)
        sync = np.where(member, clocks, -np.inf).max(axis=1, initial=-np.inf)
        for si, lane in enumerate(lanes):
            gi = gis[si]
            if gi.size == 0:
                continue
            tc = comm_time(v, lane.n, gi.tolist())
            wait = sync[si] - clocks[si, gi]
            lane.store.set_column(vid, wait + tc, procs=gi,
                                  counters={"wait_s": wait,
                                            "comm_bytes": v.comm_bytes})
            clocks[si, gi] = sync[si] + tc


def _replay(psg: PSG, lanes: List[_Lane], clocks: np.ndarray,
            comm_time: Callable, jitter: float, p2p: str) -> List[int]:
    """Advance every lane through the vertex schedule in ONE pass.

    ``clocks`` is the stacked (S, P_max) clock matrix; ``lanes[si].clocks``
    is row ``si`` and entries ``>= lane.n`` are masked (never read or
    written).  Comp legs advance the whole matrix in one add; collective
    legs synchronize all scales in one cross-scale masked max
    (:func:`_collective_stacked`); only p2p legs stay per-scale (their
    wavefront rounds depend on the lane's proc count).
    """
    if p2p not in P2P_MODES:
        raise ValueError(f"p2p mode must be one of {P2P_MODES}: {p2p!r}")
    sched = schedule(psg)
    S, P_max = clocks.shape
    rounds_cache: Dict[Tuple[int, int], List] = {}
    t_stack = np.zeros((S, P_max))

    for vid in sched:
        v = psg.vertices[vid]
        if v.kind == COMM:
            if v.p2p_pairs:
                for lane in lanes:
                    tc = comm_time(v, lane.n, [0, 1])
                    rounds = None
                    if p2p != "sequential":
                        key = (vid, lane.n)
                        rounds = rounds_cache.get(key, False)
                        if rounds is False:
                            # "auto" bails out of peeling on degenerate
                            # chains (one pair per round) — the per-pair
                            # reference loop is the better executor there
                            rounds = rounds_cache[key] = p2p_rounds(
                                vertex_pairs_array(v), lane.n,
                                bail=(p2p == "auto"))
                    if rounds is None:
                        _p2p_sequential(lane, v, vid, tc)
                    else:
                        _p2p_wavefront(lane, v, vid, tc, rounds)
            else:
                _collective_stacked(lanes, clocks, v, vid, comm_time)
            continue
        # Comp / atomic control: one stacked clock advance for all scales
        t_stack[:] = 0.0
        for si, lane in enumerate(lanes):
            t = lane.base(vid)
            np.maximum(t, 0.0, out=t)
            for p, extra in lane.inj.get(vid, {}).items():
                t[p] += extra
            if jitter:
                t *= 1.0 + jitter * lane.rng.standard_normal(lane.n)
                np.maximum(t, 0.0, out=t)
            lane.store.set_column(vid, t, counters={"flops": v.flops,
                                                    "bytes": v.bytes})
            t_stack[si, :lane.n] = t
        clocks += t_stack
    return sched


def _resolve_shards(shards, n_procs: int):
    """``shards=`` argument -> list of (start, stop) host ranges or None."""
    if shards is None:
        return None
    if isinstance(shards, (int, np.integer)):
        return shard_ranges(n_procs, int(shards))
    ranges = [(int(lo), int(hi)) for lo, hi in shards]
    if not ranges or ranges[-1][1] != n_procs:
        # the replay writes every process; a partial tiling would silently
        # drop rows (ShardedStore checks contiguity-from-0, not the end)
        raise ValueError(f"shard ranges must cover [0, {n_procs}): {ranges}")
    return ranges


def _make_lane(psg: PSG, n_procs: int, base_times: Callable, seed: int,
               inject, clocks_row: np.ndarray, shards=None) -> _Lane:
    ranges = _resolve_shards(shards, n_procs)
    store = PerfStore(n_procs, len(psg.vertices)) if ranges is None else \
        ShardedStore(ranges, len(psg.vertices))
    return _Lane(n=n_procs, base=_BaseTimes(base_times, n_procs),
                 store=store,
                 rng=np.random.default_rng(seed),
                 inj=_inject_by_vid(inject, n_procs),
                 clocks=clocks_row)


def _finish(psg: PSG, lane: _Lane) -> PPG:
    ppg = build_ppg(psg, lane.n, lane.store)
    ppg.meta["makespan"] = float(lane.clocks[:lane.n].max()) if lane.n \
        else 0.0
    return ppg


def simulate(psg: PSG, n_procs: int,
             base_times: Callable,
             *,
             inject: Optional[Mapping[Tuple[int, int], float]] = None,
             comm_time: Callable = default_comm_time,
             jitter: float = 0.0,
             seed: int = 0,
             p2p: str = "auto",
             shards=None) -> SimResult:
    """Run the dependence simulation.

    ``base_times(procs_array, vid) -> per-process seconds`` for
    Comp/atomic-control vertices (vectorized; scalar ``(proc, vid) ->
    float`` callables are auto-detected and shimmed).
    ``inject``: ``{(proc, vid): extra_seconds}`` delay injection.
    ``p2p``: ``"auto"`` (default) | ``"wavefront"`` | ``"sequential"`` —
    all three produce bit-identical results; "sequential" is the retained
    per-pair reference loop, "wavefront" replays disjoint rounds as
    batched gather/scatters, and "auto" picks per vertex.
    ``shards``: multi-host replay — a host count or explicit (start, stop)
    proc ranges.  Perf writes land in per-host
    :class:`~repro_torch.core.shard.PerfShard` blocks behind a
    :class:`~repro_torch.core.shard.ShardedStore` (the PPG keeps the sharded
    store; ``result.shards`` exposes the blocks), bit-identical to the
    unsharded store entry for entry.

    Perf data is written straight into a :class:`PerfStore` — whole
    (proc,)-columns for Comp/collective legs, batched
    :meth:`PerfStore.set_entries` scatters per p2p wavefront round — so
    simulation cost is O(V) vectorized steps, not O(P*V) Python object
    churn.  Counter writes go through the store's column-sparse layout:
    ``wait_s``/``comm_bytes`` materialize only at Comm vertices,
    ``flops``/``bytes`` only at Comp vertices, so counter memory tracks
    the defining vertex subset, not (P, V).
    """
    n_procs = int(n_procs)
    clocks = np.zeros((1, max(n_procs, 1)))
    lane = _make_lane(psg, n_procs, base_times, seed, inject, clocks[0],
                      shards=shards)
    sched = _replay(psg, [lane], clocks, comm_time, jitter, p2p)
    return SimResult(ppg=_finish(psg, lane),
                     clocks=lane.clocks[:n_procs].tolist(), sched=sched)


# ---------------------------------------------------------------------------
# Multi-scale series generation (non-scalable vertex detection input)
# ---------------------------------------------------------------------------

def ideal_strong_scaling(t1: float):
    return lambda p: t1 / p


def serial_fraction(t1: float, frac: float):
    """Amdahl: a fraction of the vertex does not parallelize."""
    return lambda p: t1 * (frac + (1.0 - frac) / p)


def _scale_base(time_at_scale: Callable, n: int) -> Callable:
    """Bind the scale argument, propagating the vectorization marker."""
    def fn(p, vid):
        return time_at_scale(p, vid, n)
    flag = getattr(time_at_scale, "scalana_vectorized", None)
    if flag is not None:
        fn.scalana_vectorized = flag
    return fn


def simulate_series(psg: PSG, scales: Sequence[int],
                    time_at_scale: Callable,
                    *,
                    inject: Optional[Mapping[Tuple[int, int], float]] = None,
                    comm_time: Callable = default_comm_time,
                    jitter: float = 0.0, seed: int = 0,
                    p2p: str = "auto") -> Dict[int, PPG]:
    """{n_procs: PPG} series in ONE stacked pass.

    ``time_at_scale(procs_array, vid, n_procs) -> per-process seconds``
    encodes the scaling law (scalar ``(proc, vid, n) -> float`` callables
    are shimmed like :func:`simulate`'s).  The vertex schedule is walked
    exactly once: per-scale clocks form an (S, P_max) masked matrix
    advanced per scheduled vertex for all scales simultaneously, and each
    scale writes into its own :class:`PerfStore`.  Results are
    bit-identical to S independent :func:`simulate` calls with
    ``seed=seed + n``.
    """
    ns = [int(n) for n in scales]
    if not ns:
        return {}
    clocks = np.zeros((len(ns), max(max(ns), 1)))
    lanes = [_make_lane(psg, n, _scale_base(time_at_scale, n), seed + n,
                        inject, clocks[si])
             for si, n in enumerate(ns)]
    _replay(psg, lanes, clocks, comm_time, jitter, p2p)
    return {lane.n: _finish(psg, lane) for lane in lanes}

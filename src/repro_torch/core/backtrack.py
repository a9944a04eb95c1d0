"""Backtracking root-cause detection (paper §IV-B, Algorithm 1).

All edges are traversed in reverse (dependence direction).  From each
problematic vertex we walk backward:

  * at a p2p Comm vertex with a waiting event — follow the inter-process
    communication-dependence edge to the partner process (edges without a
    waiting event are pruned, the paper's search-space optimization);
  * at an unscanned Loop/Branch vertex — follow the control-dependence edge
    into the structure (continue from its *end* vertex);
  * otherwise — follow the data-dependence edge to the predecessor (the
    max-time predecessor when several exist);
  * stop at the root or at a collective-communication vertex, except a
    collective *start* vertex, where the walk jumps to the process whose
    late arrival everyone waited on.

The result is a set of causal paths over (process, vertex) pairs whose
endpoints are the root-cause candidates, reported with source locations.

Two engines produce identical paths:

* the scalar walk (``backtrack_scalar`` / ``backtrack_one``) — a direct
  transcription of Algorithm 1, retained as the property-tested reference;
* the frontier-batched walk (``backtrack_batched``, the default) — ALL
  flagged (proc, vertex) start nodes advance in lockstep, one step per
  iteration: data-dependence predecessors for the whole frontier are one
  padded gather + argmax over the time matrix, collective late-arriver
  lookups are one cached per-vertex argmin over the participant group
  (``CommIndex``), and waiting-p2p partners resolve through the explicit
  reverse-edge index.  Algorithm 1's sequential ``scanned``-set semantics
  (earlier paths prune later ones) are restored afterwards by an
  acceptance pass: paths are admitted in start order, and any path whose
  nodes — or whose branch-deciding probe nodes — touch an already-scanned
  node is recomputed with the scalar walk against the true scanned set.
  Disjoint paths (the overwhelmingly common case) keep their batched
  result, so root-cause detection at 8k processes with hundreds of
  flagged vertices is no longer bound by per-node Python scans.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.detect import Abnormal, NonScalable
from repro_torch.core.graph import BRANCH, CALL, COMM, LOOP, PPG, PSG, ROOT

Node = Tuple[int, int]                     # (proc, vid)

WAIT_COUNTER = "wait_s"
WAIT_EPS = 1e-9


@dataclasses.dataclass
class Path:
    nodes: List[Node]
    start_reason: str                      # "non_scalable" | "abnormal"

    @property
    def root_cause(self) -> Node:
        return self.nodes[-1]

    def __iter__(self):
        return iter(self.nodes)


class _SeenUnion:
    """Non-copying membership view over (scanned, own-path) node sets.

    ``backtrack_one`` used to rebuild ``scanned | set(path)`` on every
    step — an O(|scanned| + |path|) copy per node that goes quadratic
    when hundreds of conflicting paths fall back to the scalar walk over
    a large scanned set.  The walk only ever asks ``node in visited``, so
    a chained-membership wrapper over the two live sets (the path set
    updated incrementally on append) is semantically identical and O(1)
    per probe."""

    __slots__ = ("scanned", "path")

    def __init__(self, scanned: Set[Node], path: Set[Node]):
        self.scanned = scanned
        self.path = path

    def __contains__(self, node) -> bool:
        return node in self.scanned or node in self.path


def _wait_of(ppg: PPG, node: Node) -> float:
    return ppg.perf.counter_at(WAIT_COUNTER, *node)


def _is_collective(psg: PSG, vid: int) -> bool:
    v = psg.vertices[vid]
    return v.kind == COMM and not v.p2p_pairs


def _is_p2p(psg: PSG, vid: int) -> bool:
    v = psg.vertices[vid]
    return v.kind == COMM and bool(v.p2p_pairs)


def _data_pred(ppg: PPG, node: Node, visited) -> Optional[Node]:
    proc, vid = node
    preds = ppg.psg.preds(vid, "data")
    cands = [(proc, p) for p in preds if (proc, p) not in visited]
    if not cands:
        return None
    return max(cands, key=lambda n: ppg.get_time(*n))


def _control_end(ppg: PPG, node: Node, visited) -> Optional[Node]:
    """Continue from the end (last child) of a Loop/Branch structure."""
    proc, vid = node
    kids = ppg.psg.children(vid)
    for k in reversed(kids):
        if (proc, k) not in visited:
            return (proc, k)
    return None


def _comm_partner(ppg: PPG, node: Node, visited) -> Optional[Node]:
    partners = [p for p in ppg.comm_partners(*node) if p not in visited]
    if not partners:
        return None
    # the cause is the partner we waited for: latest/most loaded one
    return max(partners, key=lambda n: ppg.get_time(*n))


def _latest_participant(ppg: PPG, node: Node) -> Optional[Node]:
    """For a collective start vertex: the process everyone waited on —
    the participant with the smallest wait (it arrived last)."""
    proc, vid = node
    group = [p for p in ppg.comm_partners(proc, vid)] + [node]
    if len(group) <= 1:
        return None
    return min(group, key=lambda n: _wait_of(ppg, n))


def backtrack_one(ppg: PPG, start: Node, *, reason: str,
                  scanned: Set[Node], max_len: int = 256) -> Path:
    psg = ppg.psg
    path: List[Node] = []
    path_set: Set[Node] = set()
    # visited == scanned | set(path) at every step, without the per-step
    # union copy (quadratic over many conflicting scalar-fallback paths)
    visited = _SeenUnion(scanned, path_set)
    v: Optional[Node] = start
    first = True
    while v is not None and len(path) < max_len:
        proc, vid = v
        vert = psg.vertices[vid]
        if vert.kind == "Root":
            break
        if _is_collective(psg, vid) and not first:
            path.append(v)                  # terminal collective
            break
        path.append(v)
        path_set.add(v)
        nxt: Optional[Node] = None
        if _is_collective(psg, vid):        # collective start vertex
            late = _latest_participant(ppg, v)
            if late is not None and late not in visited:
                nxt = _data_pred(ppg, late, visited) or late
            else:
                nxt = _data_pred(ppg, v, visited)
        elif _is_p2p(psg, vid):
            if _wait_of(ppg, v) > WAIT_EPS:     # pruning: only waiting edges
                nxt = _comm_partner(ppg, v, visited)
            if nxt is None:
                nxt = _data_pred(ppg, v, visited)
        elif vert.kind in (LOOP, BRANCH, CALL) and v not in scanned:
            nxt = _control_end(ppg, v, visited) or _data_pred(ppg, v, visited)
        else:
            nxt = _data_pred(ppg, v, visited)
        first = False
        v = nxt
    scanned.update(path)
    return Path(nodes=path, start_reason=reason)


def _start_nodes(ppg: PPG, non_scalable: Sequence[NonScalable],
                 abnormal: Sequence[Abnormal]) -> List[Tuple[Node, str]]:
    """Algorithm 1 Main()'s start order: non-scalable vertices (walked from
    their slowest process) first, then abnormal (proc, vertex) pairs."""
    tm = ppg.times_matrix()
    starts: List[Tuple[Node, str]] = []
    for n in non_scalable:
        proc = int(tm[:, n.vid].argmax()) if tm.size else 0
        starts.append(((proc, n.vid), "non_scalable"))
    for a in abnormal:
        starts.append(((a.proc, a.vid), "abnormal"))
    return starts


def backtrack_scalar(ppg: PPG, non_scalable: Sequence[NonScalable],
                     abnormal: Sequence[Abnormal]) -> List[Path]:
    """Algorithm 1 Main(), one sequential scalar walk per start node: the
    retained reference implementation (``backtrack_batched`` must — and is
    property-tested to — return exactly these paths)."""
    scanned: Set[Node] = set()
    paths: List[Path] = []
    for node, reason in _start_nodes(ppg, non_scalable, abnormal):
        if reason == "abnormal" and node in scanned:
            continue
        p = backtrack_one(ppg, node, reason=reason, scanned=scanned)
        if p.nodes:
            paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# frontier-batched walk
# ---------------------------------------------------------------------------

# per-vertex walk categories (process-independent, computed once per call)
_K_ROOT, _K_COLL, _K_P2P, _K_CTRL, _K_DATA = range(5)


class _Frontier:
    """Array context for the batched walk: the time/wait matrices, padded
    data-predecessor table, per-vertex category codes, and a lazy cache of
    per-collective late-arriver lookups (one vectorized argmin over the
    participant group per vertex, shared by every path that reaches it)."""

    __slots__ = ("ppg", "psg", "T", "W", "kcode", "PRED", "_late")

    def __init__(self, ppg: PPG):
        self.ppg = ppg
        self.psg = psg = ppg.psg
        V = len(psg.vertices)
        self.T = ppg.times_matrix()
        self.W = _wait_matrix(ppg)
        kcode = np.full(V, _K_DATA, np.int8)
        for v in psg.vertices:
            if v.kind == ROOT:
                kcode[v.vid] = _K_ROOT
            elif v.kind == COMM:
                kcode[v.vid] = _K_P2P if v.p2p_pairs else _K_COLL
            elif v.kind in (LOOP, BRANCH, CALL):
                kcode[v.vid] = _K_CTRL
        self.kcode = kcode
        plists = [psg.preds(v.vid, "data") for v in psg.vertices]
        kp = max((len(p) for p in plists), default=1) or 1
        self.PRED = np.full((V, kp), -1, np.intp)
        for vid, ps in enumerate(plists):
            self.PRED[vid, :len(ps)] = ps
        self._late: Dict[int, Tuple] = {}

    def late_info(self, vid: int) -> Tuple:
        """Cached late-arriver lookup for one collective vertex.

        Returns ("map", gid_of, per_group): ``gid_of`` maps proc -> group
        index (-1: not a participant) and ``per_group[gid]`` is the
        group's (first_min_wait_proc, second_min_wait_proc | None) — one
        vectorized argmin over each participant group, shared by every
        path that reaches the vertex.  ("none", ...) when the vertex has
        no groups; ("complex", ...) when groups overlap or name unknown
        procs (those paths fall back to the scalar walk)."""
        info = self._late.get(vid)
        if info is None:
            groups = self.ppg.comm.groups_of(vid)
            if not groups:
                info = ("none", None, None)
            else:
                gid_of = np.full(self.ppg.n_procs, -1, np.intp)
                per: List[Tuple[int, Optional[int]]] = []
                info = None
                for gi, g in enumerate(groups):
                    garr = np.asarray(g, np.intp)
                    if garr.size and (garr.min() < 0
                                      or garr.max() >= gid_of.size) \
                            or (gid_of[garr] != -1).any():
                        info = ("complex", None, None)
                        break
                    gid_of[garr] = gi
                    w = self.W[garr, vid]
                    m = w.min()
                    firsts = np.flatnonzero(w == m)
                    q1 = int(garr[firsts[0]])
                    q2 = int(garr[firsts[1]]) if firsts.size > 1 else None
                    per.append((q1, q2))
                if info is None:
                    info = ("map", gid_of, per)
            self._late[vid] = info
        return info


def backtrack_batched(ppg: PPG, non_scalable: Sequence[NonScalable],
                      abnormal: Sequence[Abnormal], *,
                      max_len: int = 256) -> List[Path]:
    """Frontier-batched Algorithm 1: identical paths to
    :func:`backtrack_scalar`, computed by advancing every start node in
    lockstep over array gathers (see the module docstring).

    Batched paths exclude only their OWN nodes while walking; the
    sequential cross-path pruning is restored by the acceptance pass
    below, which recomputes — with the exact scalar walk — any path that
    touched a node (or probed a late-arriver) already scanned by an
    earlier path.  A selector over candidates not in ``scanned | path``
    picks the same node as one over candidates not in ``path`` whenever
    the pick is unscanned, so untouched batched paths are exact.
    """
    starts = _start_nodes(ppg, non_scalable, abnormal)
    N = len(starts)
    if N == 0:
        return []
    ctx = _Frontier(ppg)
    comm = ppg.comm
    paths: List[List[Node]] = [[] for _ in range(N)]
    probes: List[List[Node]] = [[] for _ in range(N)]
    visited: List[Set[Node]] = [set() for _ in range(N)]
    conflict = np.zeros(N, bool)
    cur_p = np.fromiter((s[0][0] for s in starts), np.intp, N)
    cur_v = np.fromiter((s[0][1] for s in starts), np.intp, N)
    alive = np.ones(N, bool)
    first = np.ones(N, bool)

    while alive.any():
        idx = np.nonzero(alive)[0]
        lens = np.fromiter((len(paths[i]) for i in idx), np.intp, idx.size)
        over = lens >= max_len
        if over.any():
            alive[idx[over]] = False
            idx = idx[~over]
            if idx.size == 0:
                break
        vs, ps = cur_v[idx], cur_p[idx]
        kc = ctx.kcode[vs]
        mroot = kc == _K_ROOT
        alive[idx[mroot]] = False
        mterm = (kc == _K_COLL) & ~first[idx]
        for i, p, v in zip(idx[mterm].tolist(), ps[mterm].tolist(),
                           vs[mterm].tolist()):
            paths[i].append((p, v))             # terminal collective
            alive[i] = False
        live = ~mroot & ~mterm
        lidx, lps, lvs, lkc = idx[live], ps[live], vs[live], kc[live]
        for i, p, v in zip(lidx.tolist(), lps.tolist(), lvs.tolist()):
            paths[i].append((p, v))
            visited[i].add((p, v))

        # -- choose the next node per path ------------------------------
        # data-pred requests accumulate and resolve in ONE padded
        # gather+argmax over the time matrix for the whole frontier
        nxt: List[Optional[Node]] = [None] * lidx.size
        req: List[Tuple[int, int, int, Optional[Node]]] = []
        for k in range(lidx.size):
            i = int(lidx[k])
            p, v, code = int(lps[k]), int(lvs[k]), int(lkc[k])
            if code == _K_COLL:                 # collective start vertex
                tag, gid_of, per = ctx.late_info(v)
                if tag == "complex" or comm.p2p_preds_of((p, v)):
                    conflict[i] = True          # scalar walk handles it
                    alive[i] = False
                    continue
                late: Optional[Node] = None
                if tag == "map" and gid_of[p] >= 0:
                    q1, q2 = per[gid_of[p]]
                    lp = q1 if q1 != p else (q2 if q2 is not None else p)
                    late = (lp, v)
                    if late != (p, v):
                        probes[i].append(late)  # scanned-sensitive branch
                if late is not None and late not in visited[i]:
                    req.append((k, late[0], v, late))   # pred-of-late|late
                else:
                    req.append((k, p, v, None))         # pred-of-v | stop
            elif code == _K_P2P:
                chosen = None
                if ctx.W[p, v] > WAIT_EPS:      # pruning: waiting edges only
                    if comm.has_groups(v):
                        conflict[i] = True
                        alive[i] = False
                        continue
                    best_t = -np.inf
                    for q in comm.p2p_preds_of((p, v)):
                        if q in visited[i]:
                            continue
                        tq = ctx.T[q[0], q[1]]
                        if tq > best_t:
                            chosen, best_t = q, tq
                if chosen is not None:
                    nxt[k] = chosen
                else:
                    req.append((k, p, v, None))
            elif code == _K_CTRL:               # continue from structure end
                chosen = None
                for c in reversed(ctx.psg.children(v)):
                    if (p, c) not in visited[i]:
                        chosen = (p, c)
                        break
                if chosen is not None:
                    nxt[k] = chosen
                else:
                    req.append((k, p, v, None))
            else:
                req.append((k, p, v, None))

        if req:
            rp = np.fromiter((r[1] for r in req), np.intp, len(req))
            rv = np.fromiter((r[2] for r in req), np.intp, len(req))
            cand = ctx.PRED[rv]                             # (M, Kp)
            valid = cand >= 0
            t = np.where(valid,
                         ctx.T[rp[:, None], np.where(valid, cand, 0)],
                         -np.inf)
            ji = np.argmax(t, axis=1)                       # first max
            has = valid[np.arange(len(req)), ji]
            for m, (k, _, _, fallback) in enumerate(req):
                i = int(lidx[k])
                if not alive[i]:
                    continue
                chosen = None
                if has[m]:
                    node = (int(rp[m]), int(cand[m, ji[m]]))
                    if node not in visited[i]:
                        chosen = node
                    else:      # rare: rescan candidates minus own path
                        best_t = -np.inf
                        for c in cand[m][valid[m]].tolist():
                            node = (int(rp[m]), int(c))
                            if node in visited[i]:
                                continue
                            tc = ctx.T[node[0], c]
                            if tc > best_t:
                                chosen, best_t = node, tc
                if chosen is None and fallback is not None \
                        and fallback not in visited[i]:
                    chosen = fallback                       # the `or late`
                nxt[k] = chosen

        for k in range(lidx.size):
            i = int(lidx[k])
            if not alive[i]:
                continue
            node = nxt[k]
            if node is None:
                alive[i] = False
            else:
                cur_p[i], cur_v[i] = node
        first[idx] = False

    # -- acceptance: restore the sequential scanned-set semantics -------
    scanned: Set[Node] = set()
    out: List[Path] = []
    for j, (node, reason) in enumerate(starts):
        if reason == "abnormal" and node in scanned:
            continue
        if conflict[j] or any(n in scanned for n in paths[j]) \
                or any(q in scanned for q in probes[j]):
            p = backtrack_one(ppg, node, reason=reason, scanned=scanned,
                              max_len=max_len)
        else:
            p = Path(nodes=paths[j], start_reason=reason)
            scanned.update(paths[j])
        if p.nodes:
            out.append(p)
    return out


BACKTRACK_MODES = ("auto", "batched", "scalar")


def backtrack(ppg: PPG, non_scalable: Sequence[NonScalable],
              abnormal: Sequence[Abnormal], *,
              mode: str = "auto") -> List[Path]:
    """Algorithm 1 Main(): non-scalable starts first, then unscanned
    abnormal vertices.

    ``mode``: "scalar" (the per-start reference walk), "batched" (the
    frontier-batched engine, opt-in), or "auto" (default — scalar).
    Batched was the "auto" pick while the scalar walk's per-step
    scanned-set copies went quadratic; with the non-copying union view
    the scalar walk wins or ties across BENCH_graph_scale.json
    (0.62-1.12x), so the simpler engine is the default and batched is
    kept for workloads with very many long disjoint walks.  All modes
    return identical paths."""
    if mode not in BACKTRACK_MODES:
        raise ValueError(f"mode must be one of {BACKTRACK_MODES}: {mode!r}")
    if mode == "batched":
        return backtrack_batched(ppg, non_scalable, abnormal)
    return backtrack_scalar(ppg, non_scalable, abnormal)


def _anomaly_score(ppg: PPG, node: Node,
                   busy: Optional[np.ndarray] = None) -> float:
    """BUSY time above the cross-process typical for this vertex.

    A propagated delay leaves every downstream vertex time-NORMAL (they
    run at base speed, just later) and surfaces as WAITING at comm
    vertices — which are symptoms, not causes.  Scoring busy time
    (time - wait) makes the most anomalous node on a causal path the
    worker that actually ran long, i.e. the root-cause candidate.

    ``busy`` is the precomputed (n_procs, V) time-minus-wait matrix; pass
    it when scoring many nodes so each call is one column reduction."""
    if node not in ppg.perf:
        return 0.0
    if busy is None:
        busy = _busy_matrix(ppg)
    proc, vid = node
    col = busy[:, vid]
    mine = float(col[proc])
    others = np.sort(col[col > 0.0])           # unset entries are 0: excluded
    if others.size == 0:
        return mine
    return mine - float(others[others.size // 2])


def _wait_matrix(ppg: PPG) -> np.ndarray:
    """Dense (n_procs, V) ``wait_s`` (0.0 where unset) from the compressed
    counter columns — works unchanged on sharded stores, whose
    ``counter_columns`` is the stacked per-host view."""
    n = len(ppg.psg.vertices)
    out = np.zeros((ppg.n_procs, n))
    vids, values, mask = ppg.perf.counter_columns(WAIT_COUNTER)
    keep = vids < n
    if keep.any():
        out[:, vids[keep]] = np.where(mask[:, keep], values[:, keep], 0.0)
    return out


def _busy_matrix(ppg: PPG) -> np.ndarray:
    """time minus wait, (n_procs, V) — expanded from the column-sparse
    ``wait_s`` counter (see :func:`_wait_matrix`)."""
    return ppg.times_matrix() - _wait_matrix(ppg)


def root_causes(paths: Sequence[Path], psg: PSG, top_k: int = 5,
                ppg: Optional[PPG] = None) -> List[Tuple[Node, str, str]]:
    """Deduplicated root-cause vertices (node, name, source).

    With a PPG, each path contributes its most ANOMALOUS node (see
    _anomaly_score); without perf data, its terminal node (the paper's
    raw Algorithm-1 endpoint).  Ranked by path count, then score."""
    counts: Dict[Node, int] = {}
    scores: Dict[Node, float] = {}
    busy = _busy_matrix(ppg) if ppg is not None else None
    memo: Dict[Node, float] = {}

    def score(n: Node) -> float:
        if n not in memo:
            memo[n] = _anomaly_score(ppg, n, busy)
        return memo[n]

    for p in paths:
        if ppg is not None and p.nodes:
            node = max(p.nodes, key=score)
            scores[node] = max(scores.get(node, 0.0), score(node))
        else:
            node = p.root_cause
        counts[node] = counts.get(node, 0) + 1
    ranked = sorted(counts,
                    key=lambda n: (-counts[n], -scores.get(n, 0.0)))[:top_k]
    out = []
    for node in ranked:
        v = psg.vertices[node[1]]
        out.append((node, v.name, v.source))
    return out

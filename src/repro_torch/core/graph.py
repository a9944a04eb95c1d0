"""Program Structure Graph (PSG) and Program Performance Graph (PPG).

Vertex kinds follow the paper (§III-A): Loop, Branch, Call, Comp, plus Comm
(the MPI-vertex analogue: XLA/JAX collectives).  Edges carry a dependence
kind: 'data' (sequential data flow), 'control' (enclosing control structure)
and — on the PPG — 'comm' (inter-process communication dependence).

Complexity guarantees (the indexed graph core):

* ``PSG.children`` / ``preds`` / ``succs`` / ``by_kind`` are O(result) — the
  adjacency and kind indexes are maintained incrementally by ``new_vertex``,
  ``add_edge`` and ``set_parent``, never by rescanning all V vertices or E
  edges.
* ``PPG.perf`` is an array store (:class:`PerfStore`): time / variance /
  sample matrices of shape (n_procs, n_vertices), counters column-sparse
  (:class:`CounterColumns` — a counter only materializes at the vertex
  subset that defines it, e.g. ``wait_s`` at Comm vertices).
  ``times_across_procs`` and the detectors' cross-process reductions are
  numpy slices, O(P) memory with no per-entry Python objects.
* Collective communication dependence is implicit: ``add_collective_edges``
  records the participant *group* (O(|group|) storage) instead of
  materializing the O(|group|²) clique.  ``comm_partners`` resolves partners
  lazily; only p2p edges are stored explicitly.  At 8192 processes a single
  all-reduce costs one 8192-entry tuple, not 67M edge tuples.
"""
from __future__ import annotations

import dataclasses
import json
import weakref
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Set, Tuple)

import numpy as np

LOOP = "Loop"
BRANCH = "Branch"
CALL = "Call"
COMP = "Comp"
COMM = "Comm"
ROOT = "Root"

KINDS = (LOOP, BRANCH, CALL, COMP, COMM, ROOT)


def pairs_array(pairs) -> np.ndarray:
    """(n, 2) intp array from a p2p pair list."""
    if isinstance(pairs, np.ndarray):
        return pairs.reshape(-1, 2).astype(np.intp, copy=False)
    return np.asarray(pairs, np.intp).reshape(-1, 2)


def check_tree_format(meta: Optional[Mapping[str, Any]], expect: str,
                      latest: int) -> int:
    """Validate a ``to_tree`` meta header and return its version.

    Every serializable graph object stamps its meta with
    ``{"format": <name>, "version": <int>}``; loaders call this first so
    a tree saved by a NEWER layout fails loudly instead of reloading
    garbage.  ``meta`` may be ``None`` or headerless (snapshots written
    before the seam was versioned): those are treated as version 1 of
    the expected format — the pre-versioning layout is identical.
    """
    if not meta:
        return 1
    fmt = meta.get("format", expect)
    if fmt != expect:
        raise ValueError(f"tree format {fmt!r}, expected {expect!r}")
    version = int(meta.get("version", 1))
    if version < 1 or version > latest:
        raise ValueError(f"{expect} tree version {version} unsupported "
                         f"(latest known: {latest})")
    return version

# collective primitives / HLO ops treated as Comm vertices
COLLECTIVE_PRIMS = {
    "psum", "pmax", "pmin", "all_gather", "all_gather_invariant",
    "reduce_scatter", "all_to_all", "ppermute", "psum_scatter",
}
P2P_PRIMS = {"ppermute"}     # point-to-point-like (explicit src->dst pairs)


# per-Vertex cache of the array form of p2p_pairs: converting an 8k-tuple
# list costs milliseconds, and the replay engine + PPG assembly both need
# it every call.  Keyed by id() with a weakref guard (Vertex is an
# eq-dataclass, so not hashable); validated by CONTENT equality against a
# snapshot copy — ~60x cheaper than reconversion (the snapshot shares the
# tuple objects, so == short-circuits on identity) and sound under any
# mutation, in-place element edits included.  Entries are dropped when
# their vertex dies.
_PAIRS_ARRAYS: Dict[int, Tuple] = {}


def vertex_pairs_array(v: "Vertex") -> np.ndarray:
    """Cached :func:`pairs_array` of ``v.p2p_pairs``."""
    pairs = v.p2p_pairs
    key = id(v)
    hit = _PAIRS_ARRAYS.get(key)
    if hit is not None and hit[0]() is v and hit[1] == pairs:
        return hit[2]
    arr = pairs_array(pairs)

    def _drop(_ref, _key=key):
        _PAIRS_ARRAYS.pop(_key, None)

    _PAIRS_ARRAYS[key] = (weakref.ref(v, _drop), list(pairs), arr)
    return arr


@dataclass
class Vertex:
    vid: int
    kind: str
    name: str                         # primitive / structure name
    source: str = ""                  # "file.py:123" best user frame
    parent: int = -1                  # enclosing Loop/Branch/Call vid
    depth: int = 0                    # control-nest depth
    prims: List[str] = field(default_factory=list)
    # static "hardware counters" (PAPI analogue), per single execution:
    flops: float = 0.0
    bytes: float = 0.0
    comm_bytes: float = 0.0
    comm_kind: str = ""               # all_reduce | all_gather | ...
    p2p_pairs: List[Tuple[int, int]] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def is_comm(self) -> bool:
        return self.kind == COMM

    @property
    def is_control(self) -> bool:
        return self.kind in (LOOP, BRANCH, CALL)


class EdgeSet:
    """Set of (src, dst, kind) edges with incrementally-maintained per-vertex
    adjacency lists, so ``preds``/``succs`` are O(degree) not O(E)."""

    __slots__ = ("_set", "_preds", "_succs")

    def __init__(self, items: Iterable[Tuple[int, int, str]] = ()):
        self._set: Set[Tuple[int, int, str]] = set()
        self._preds: Dict[int, List[Tuple[int, str]]] = {}
        self._succs: Dict[int, List[Tuple[int, str]]] = {}
        for e in items:
            self.add((e[0], e[1], e[2]))

    def add(self, edge: Tuple[int, int, str]) -> None:
        if edge in self._set:
            return
        self._set.add(edge)
        s, d, k = edge
        self._preds.setdefault(d, []).append((s, k))
        self._succs.setdefault(s, []).append((d, k))

    def preds(self, vid: int, kind: Optional[str] = None) -> List[int]:
        lst = self._preds.get(vid, ())
        if kind is None:
            return [s for s, _ in lst]
        return [s for s, k in lst if k == kind]

    def succs(self, vid: int, kind: Optional[str] = None) -> List[int]:
        lst = self._succs.get(vid, ())
        if kind is None:
            return [d for d, _ in lst]
        return [d for d, k in lst if k == kind]

    def __contains__(self, edge) -> bool:
        return tuple(edge) in self._set

    def __iter__(self) -> Iterator[Tuple[int, int, str]]:
        return iter(self._set)

    def __len__(self) -> int:
        return len(self._set)

    def __eq__(self, other) -> bool:
        if isinstance(other, EdgeSet):
            return self._set == other._set
        if isinstance(other, (set, frozenset)):
            return self._set == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"EdgeSet({sorted(self._set)!r})"


class PSG:
    """Per-process program structure graph.

    ``order`` is program (execution) order of vertex ids.  Data-dependence
    edges are implied by consecutive order within the same parent; control
    edges connect a control vertex to its children.  Both are materialized
    in ``edges`` for analysis/serialization.

    Adjacency (children-by-parent, preds/succs-by-kind) and kind indexes are
    maintained incrementally; reparent vertices with :meth:`set_parent` so
    the children index stays consistent.
    """

    def __init__(self, vertices: Optional[Iterable[Vertex]] = None,
                 edges: Iterable[Tuple[int, int, str]] = (), root: int = 0):
        self.vertices: List[Vertex] = []
        self._edges = EdgeSet(edges)
        self.root = root
        self._children: Dict[int, List[int]] = {}
        self._kind_index: Dict[str, List[int]] = {}
        for v in vertices or ():
            self._append_vertex(v)

    # ------------------------------------------------------------------
    @property
    def edges(self) -> EdgeSet:
        return self._edges

    @edges.setter
    def edges(self, items: Iterable[Tuple[int, int, str]]) -> None:
        self._edges = items if isinstance(items, EdgeSet) else EdgeSet(items)

    def _append_vertex(self, v: Vertex) -> None:
        self.vertices.append(v)
        self._kind_index.setdefault(v.kind, []).append(v.vid)
        if v.parent >= 0:
            self._children.setdefault(v.parent, []).append(v.vid)

    def new_vertex(self, kind: str, name: str, *, source: str = "",
                   parent: int = -1, depth: int = 0, **meta) -> Vertex:
        v = Vertex(vid=len(self.vertices), kind=kind, name=name, source=source,
                   parent=parent, depth=depth)
        for k, val in meta.items():
            setattr(v, k, val) if hasattr(v, k) else v.meta.__setitem__(k, val)
        self._append_vertex(v)
        return v

    def set_parent(self, vid: int, parent: int) -> None:
        """Reparent a vertex, keeping the children index consistent."""
        v = self.vertices[vid]
        if v.parent == parent:
            return
        if v.parent >= 0:
            kids = self._children.get(v.parent)
            if kids is not None and vid in kids:
                kids.remove(vid)
        v.parent = parent
        if parent >= 0:
            self._children.setdefault(parent, []).append(vid)

    def add_edge(self, src: int, dst: int, kind: str = "data") -> None:
        if src != dst:
            self._edges.add((src, dst, kind))

    def children(self, vid: int) -> List[int]:
        return list(self._children.get(vid, ()))

    def preds(self, vid: int, kind: Optional[str] = None) -> List[int]:
        return self._edges.preds(vid, kind)

    def succs(self, vid: int, kind: Optional[str] = None) -> List[int]:
        return self._edges.succs(vid, kind)

    def by_kind(self, kind: str) -> List[Vertex]:
        return [self.vertices[i] for i in self._kind_index.get(kind, ())]

    def stats(self) -> Dict[str, int]:
        out = {k: 0 for k in KINDS}
        for k, vids in self._kind_index.items():
            out[k] = len(vids)
        out["total"] = len(self.vertices)
        return out

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "vertices": [dataclasses.asdict(v) for v in self.vertices],
            "edges": sorted(self._edges),
            "root": self.root,
        })

    @classmethod
    def from_json(cls, text: str) -> "PSG":
        raw = json.loads(text)
        g = cls(root=raw["root"])
        for d in raw["vertices"]:
            d["p2p_pairs"] = [tuple(p) for p in d.get("p2p_pairs", [])]
            g._append_vertex(Vertex(**d))
        g.edges = {(s, d, k) for s, d, k in raw["edges"]}
        return g

    def nbytes(self) -> int:
        """Serialized storage footprint (paper Table I 'storage cost')."""
        return len(self.to_json().encode())

    # -- checkpoint-tree seam ------------------------------------------
    def to_tree(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tree, meta): the graph as a checkpoint-friendly pytree.

        The JSON form rides in a single uint8 leaf (checkpoint leaves
        are arrays, not strings); meta carries the versioned format
        header.  Round-trips through :meth:`from_tree` bit-identically.
        """
        data = np.frombuffer(self.to_json().encode(), np.uint8).copy()
        return {"json": data}, {"format": "psg", "version": 1}

    @classmethod
    def from_tree(cls, tree: Mapping[str, Any],
                  meta: Optional[Mapping[str, Any]] = None) -> "PSG":
        check_tree_format(meta, "psg", 1)
        data = np.asarray(tree["json"], np.uint8)
        return cls.from_json(data.tobytes().decode())


# ---------------------------------------------------------------------------
# PPG
# ---------------------------------------------------------------------------

@dataclass
class PerfVector:
    """Per-(process, vertex) performance vector (paper §III-B1)."""
    time: float = 0.0                 # seconds (mean over samples)
    time_var: float = 0.0
    samples: int = 0
    counters: Dict[str, float] = field(default_factory=dict)  # PAPI analogue


@dataclass
class RowBlock:
    """A self-contained copy of a row subset of a :class:`PerfStore`.

    The wire/snapshot unit of the streaming monitor: a per-host producer
    packages its shard's dirty rows as a RowBlock
    (:meth:`PerfStore.extract_rows`), and the aggregator overwrites the
    same rows of its replica with it (:meth:`PerfStore.apply_rows`) —
    full row STATE, not an increment, so re-applying a block is
    idempotent and applying blocks in sequence order reproduces the
    source store bit for bit.

    ``rows`` are row indices local to the source store; ``counters``
    maps name -> (vids, (k, m) values, (k, m) mask) restricted to the
    columns carrying data at these rows.
    """
    rows: np.ndarray                  # (k,) row indices
    n_cols: int                       # column count the matrices cover
    time: np.ndarray                  # (k, n_cols)
    time_var: np.ndarray              # (k, n_cols)
    samples: np.ndarray               # (k, n_cols) int64
    mask: np.ndarray                  # (k, n_cols) bool
    counters: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        field(default_factory=dict)

    def nbytes(self) -> int:
        n = (self.rows.nbytes + self.time.nbytes + self.time_var.nbytes
             + self.samples.nbytes + self.mask.nbytes)
        for vids, values, mask in self.counters.values():
            n += vids.nbytes + values.nbytes + mask.nbytes
        return n


class CounterColumns:
    """Column-sparse per-counter storage (a CSC layout over vertex ids).

    A counter like ``wait_s`` only exists at the vertex subset that defines
    it (Comm vertices), so its matrix is stored as a dense (n_procs, k)
    block over only the k columns ever written, plus a vid -> slot map.
    Dense (n_procs, V) views are materialized on demand; ``columns()``
    exposes the compressed block directly for hot paths (backtrack's busy
    matrix subtracts ``wait_s`` at k Comm columns, not V).
    """

    __slots__ = ("n_procs", "slot_of", "vids", "values", "mask")

    def __init__(self, n_procs: int):
        self.n_procs = int(n_procs)
        self.slot_of: Dict[int, int] = {}
        self.vids: List[int] = []
        self.values = np.zeros((self.n_procs, 4))
        self.mask = np.zeros((self.n_procs, 4), bool)

    def ensure_rows(self, n_procs: int) -> None:
        """Grow the proc dimension exactly (streamed assembly adds hosts
        late; ``n_procs`` stays the logical row count, so growth is exact,
        one realloc per newly-seen host range)."""
        if n_procs <= self.n_procs:
            return
        values = np.zeros((n_procs, self.values.shape[1]))
        values[:self.n_procs] = self.values
        mask = np.zeros((n_procs, self.mask.shape[1]), bool)
        mask[:self.n_procs] = self.mask
        self.values, self.mask, self.n_procs = values, mask, n_procs

    def slot(self, vid: int) -> int:
        """Slot of ``vid``, allocating (and growing by doubling) if new."""
        s = self.slot_of.get(vid)
        if s is not None:
            return s
        s = len(self.vids)
        if s >= self.values.shape[1]:
            cap = 2 * self.values.shape[1]
            values = np.zeros((self.n_procs, cap))
            values[:, :s] = self.values[:, :s]
            mask = np.zeros((self.n_procs, cap), bool)
            mask[:, :s] = self.mask[:, :s]
            self.values, self.mask = values, mask
        self.slot_of[vid] = s
        self.vids.append(vid)
        return s

    def columns(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(vids, values, mask): the compressed (n_procs, k) block."""
        k = len(self.vids)
        return (np.asarray(self.vids, np.int64),
                self.values[:, :k], self.mask[:, :k])

    def dense(self, n_vertices: int) -> np.ndarray:
        """Materialize the (n_procs, n_vertices) view; unset entries 0.0."""
        out = np.zeros((self.n_procs, n_vertices))
        vids, values, mask = self.columns()
        keep = vids < n_vertices
        if keep.any():
            out[:, vids[keep]] = np.where(mask[:, keep], values[:, keep], 0.0)
        return out

    # -- checkpoint-tree seam ------------------------------------------
    def to_tree(self) -> Dict[str, np.ndarray]:
        """The compressed block as a pytree: (k,) vids + (n_procs, k)
        values/mask — the column-sparse layout goes to disk as-is, never
        densified to (n_procs, V)."""
        vids, values, mask = self.columns()
        return {"vids": vids.copy(), "values": values.copy(),
                "mask": mask.copy()}

    def load_tree(self, tree: Mapping[str, Any]) -> None:
        """Replace this counter's columns with a :meth:`to_tree` block
        (``n_procs`` stays; saved rows beyond it grow the store first)."""
        vids = np.asarray(tree["vids"], np.int64)
        values = np.asarray(tree["values"], float)
        mask = np.asarray(tree["mask"], bool)
        k = int(vids.size)
        rows = values.shape[0]
        self.vids = [int(v) for v in vids.tolist()]
        self.slot_of = {v: i for i, v in enumerate(self.vids)}
        cap = max(k, 4)
        self.values = np.zeros((self.n_procs, cap))
        self.mask = np.zeros((self.n_procs, cap), bool)
        if k:
            self.values[:rows, :k] = values
            self.mask[:rows, :k] = mask

    def nbytes(self) -> int:
        k = len(self.vids)
        return self.n_procs * k * 9 + 8 * k      # f64 value + bool mask + vid


class PerfStore:
    """Per-(process, vertex) performance store.

    Time / variance / sample-count data live in dense (n_procs, n_vertices)
    numpy matrices, so cross-process reductions are array slices.  Counters
    (the PAPI analogue: ``wait_s``, ``flops``, ...) are column-sparse
    :class:`CounterColumns` — each materializes only at the vertex subset
    that defines it, cutting counter memory ~V/|Comm| for comm-only
    counters at scale.  The old ``{(proc, vid): PerfVector}`` mapping API
    is preserved on top: ``store[(p, vid)]`` materializes a PerfVector view
    on demand.  Columns grow automatically when vertices are added after
    construction.
    """

    __slots__ = ("n_procs", "_cols", "time", "time_var", "samples",
                 "_mask", "_counters", "_count", "_dirty")

    def __init__(self, n_procs: int, n_vertices: int = 0):
        self.n_procs = int(n_procs)
        self._cols = max(int(n_vertices), 1)
        shape = (self.n_procs, self._cols)
        self.time = np.zeros(shape)
        self.time_var = np.zeros(shape)
        self.samples = np.zeros(shape, np.int64)
        self._mask = np.zeros(shape, bool)
        self._counters: Dict[str, CounterColumns] = {}
        self._count = 0
        # rows written since the last clear_dirty() — the device-resident
        # buffer layer (shard.TorchShardView) re-uploads only these
        self._dirty = np.zeros(self.n_procs, bool)

    # -- storage management --------------------------------------------
    def _grow(self, arr: np.ndarray, cols: int) -> np.ndarray:
        out = np.zeros((self.n_procs, cols), arr.dtype)
        out[:, :arr.shape[1]] = arr
        return out

    def ensure_columns(self, n_vertices: int) -> None:
        if n_vertices <= self._cols:
            return
        cols = max(n_vertices, 2 * self._cols)
        self.time = self._grow(self.time, cols)
        self.time_var = self._grow(self.time_var, cols)
        self.samples = self._grow(self.samples, cols)
        self._mask = self._grow(self._mask, cols)
        self._cols = cols

    def ensure_rows(self, n_procs: int) -> None:
        """Grow the proc dimension exactly to ``n_procs`` (streamed shard
        assembly registers host ranges as they arrive).  ``n_procs`` is the
        logical row count everywhere, so growth is exact — one realloc per
        newly-seen host range, not doubling."""
        if n_procs <= self.n_procs:
            return

        def grow_rows(arr: np.ndarray) -> np.ndarray:
            out = np.zeros((n_procs, arr.shape[1]), arr.dtype)
            out[:arr.shape[0]] = arr
            return out

        self.time = grow_rows(self.time)
        self.time_var = grow_rows(self.time_var)
        self.samples = grow_rows(self.samples)
        self._mask = grow_rows(self._mask)
        dirty = np.zeros(n_procs, bool)
        dirty[:self._dirty.size] = self._dirty
        self._dirty = dirty
        for cc in self._counters.values():
            cc.ensure_rows(n_procs)
        self.n_procs = int(n_procs)

    # -- dirty-row tracking (device-resident buffer feed) --------------
    def dirty_rows(self) -> np.ndarray:
        """Row indices written since the last :meth:`clear_dirty` — what an
        incremental device upload must re-transfer."""
        return np.nonzero(self._dirty)[0]

    def clear_dirty(self) -> None:
        self._dirty[:] = False

    def _counter_cols(self, name: str) -> CounterColumns:
        cc = self._counters.get(name)
        if cc is None:
            cc = self._counters[name] = CounterColumns(self.n_procs)
        return cc

    # -- matrix views (the fast path) ----------------------------------
    def time_matrix(self, n_vertices: Optional[int] = None) -> np.ndarray:
        """(n_procs, n_vertices) seconds; unset entries are 0.0."""
        if n_vertices is None or n_vertices == self._cols:
            return self.time
        if n_vertices <= self._cols:
            return self.time[:, :n_vertices]
        out = np.zeros((self.n_procs, n_vertices))
        out[:, :self._cols] = self.time
        return out

    def var_matrix(self, n_vertices: Optional[int] = None) -> np.ndarray:
        """(n_procs, n_vertices) time-variance; unset entries are 0.0."""
        if n_vertices is None or n_vertices == self._cols:
            return self.time_var
        if n_vertices <= self._cols:
            return self.time_var[:, :n_vertices]
        out = np.zeros((self.n_procs, n_vertices))
        out[:, :self._cols] = self.time_var
        return out

    def time_column(self, vid: int) -> np.ndarray:
        """(n_procs,) time at one vertex; zeros when the column is unset."""
        if vid >= self._cols:
            return np.zeros(self.n_procs)
        return self.time[:, vid]

    def time_at(self, p: int, vid: int) -> float:
        """O(1) time read; 0.0 where unset (the ``get_time`` fast path)."""
        if vid >= self._cols:
            return 0.0
        return float(self.time[p, vid])

    def counter_matrix(self, name: str,
                       n_vertices: Optional[int] = None) -> np.ndarray:
        """(n_procs, n_vertices) counter values; unset entries are 0.0.

        A dense view materialized from the sparse columns — prefer
        :meth:`counter_columns` in hot paths that touch few vertices."""
        n = self._cols if n_vertices is None else n_vertices
        cc = self._counters.get(name)
        if cc is None:
            return np.zeros((self.n_procs, n))
        return cc.dense(n)

    def counter_columns(self, name: str
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Compressed (vids, (n_procs, k) values, (n_procs, k) mask) view of
        one counter — only the k columns the counter was ever written at."""
        cc = self._counters.get(name)
        if cc is None:
            return (np.zeros(0, np.int64),
                    np.zeros((self.n_procs, 0)),
                    np.zeros((self.n_procs, 0), bool))
        return cc.columns()

    def counter_names(self) -> List[str]:
        return list(self._counters)

    # -- bulk columns (simulator / replicated-profile fast path) -------
    def set_column(self, vid: int, time, *, time_var=0.0, samples=1,
                   counters: Optional[Mapping[str, Any]] = None,
                   procs: Optional[np.ndarray] = None) -> None:
        """Set a whole vertex column (optionally a proc subset) at once."""
        self.ensure_columns(vid + 1)
        idx = slice(None) if procs is None else procs
        newly = np.count_nonzero(~self._mask[idx, vid])
        self._count += int(newly)
        self._mask[idx, vid] = True
        self._dirty[idx] = True
        self.time[idx, vid] = time
        self.time_var[idx, vid] = time_var
        self.samples[idx, vid] = samples
        for name, val in (counters or {}).items():
            cc = self._counter_cols(name)
            s = cc.slot(vid)
            cc.values[idx, s] = val
            cc.mask[idx, s] = True

    def set_entries(self, procs, vid: int, time, *, time_var=0.0, samples=1,
                    counters: Optional[Mapping[str, Any]] = None,
                    accumulate: bool = False) -> None:
        """Batched scatter write at rows ``procs`` of one vertex column.

        ``procs`` is an integer index array; ``time`` / ``time_var`` /
        ``samples`` / counter values are scalars or arrays broadcast
        against it.  With ``accumulate=True``, ``time`` and counter values
        ADD onto the existing entries — repeated indices accumulate in
        index order (``np.add.at``), which is the replay engine's per-round
        scatter; an unset entry accumulates from 0.0.  ``time_var`` and
        ``samples`` are always assigned, and the entry mask is set either
        way.  This is also the write seam for streamed/multi-host PPG
        assembly: a shard's (procs, values) block lands in one call.
        """
        procs = np.asarray(procs, np.intp)
        if procs.size == 0:
            return
        self.ensure_columns(vid + 1)
        # O(P) boolean scatter instead of an O(k log k) unique-sort: count
        # newly-set entries (duplicate indices once) and detect duplicates
        touched = np.zeros(self.n_procs, bool)
        touched[procs] = True
        unique = int(np.count_nonzero(touched)) == procs.size
        col_mask = self._mask[:, vid]
        self._count += int(np.count_nonzero(touched & ~col_mask))
        col_mask |= touched
        self._dirty |= touched
        t = np.broadcast_to(np.asarray(time, float), procs.shape)
        if not accumulate:
            self.time[procs, vid] = t
        elif unique:                           # no duplicates: gather-add
            self.time[procs, vid] += t
        else:
            np.add.at(self.time[:, vid], procs, t)
        self.time_var[procs, vid] = time_var
        self.samples[procs, vid] = samples
        for name, val in (counters or {}).items():
            cc = self._counter_cols(name)
            s = cc.slot(vid)
            va = np.broadcast_to(np.asarray(val, float), procs.shape)
            if not accumulate:
                cc.values[procs, s] = va
            elif unique:
                cc.values[procs, s] += va
            else:
                np.add.at(cc.values[:, s], procs, va)
            cc.mask[procs, s] = True

    def counter_at(self, name: str, p: int, vid: int,
                   default: float = 0.0) -> float:
        """O(1) counter read; ``default`` when the entry/counter is unset."""
        cc = self._counters.get(name)
        if cc is None:
            return default
        s = cc.slot_of.get(vid)
        if s is None or not cc.mask[p, s]:
            return default
        return float(cc.values[p, s])

    def set_entry(self, p: int, vid: int, time: float, *, time_var=0.0,
                  samples=1, counters: Optional[Mapping[str, float]] = None,
                  accumulate: bool = False) -> None:
        """Scalar write without PerfVector churn (counters merge in place).

        ``accumulate=True`` adds ``time`` / counter values onto the
        existing entry (from 0.0 when unset) — the scalar form of
        :meth:`set_entries`' accumulate mode."""
        self.ensure_columns(vid + 1)
        if not self._mask[p, vid]:
            self._count += 1
            self._mask[p, vid] = True
        self._dirty[p] = True
        if accumulate:
            self.time[p, vid] += time
        else:
            self.time[p, vid] = time
        self.time_var[p, vid] = time_var
        self.samples[p, vid] = samples
        for name, val in (counters or {}).items():
            cc = self._counter_cols(name)
            s = cc.slot(vid)
            if accumulate:
                cc.values[p, s] += val
            else:
                cc.values[p, s] = val
            cc.mask[p, s] = True

    # -- row-state transfer (the streaming monitor's delta seam) -------
    def extract_rows(self, rows) -> RowBlock:
        """Copy the full state of a row subset into a :class:`RowBlock`.

        The block carries everything those rows hold — time / variance /
        samples / entry mask, plus each counter's columns restricted to
        the ones with data at these rows — so applying it elsewhere
        (:meth:`apply_rows`) reproduces the rows exactly.  This is the
        per-host producer's flush unit: ``extract_rows(dirty_rows())``
        is a sequence-numbered shard delta."""
        rows = np.asarray(rows, np.intp)
        counters: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for name, cc in self._counters.items():
            vids, values, mask = cc.columns()
            keep = mask[rows].any(axis=0)
            if keep.any():
                counters[name] = (vids[keep].copy(),
                                  values[np.ix_(rows, np.nonzero(keep)[0])],
                                  mask[np.ix_(rows, np.nonzero(keep)[0])])
        return RowBlock(rows=rows.copy(), n_cols=self._cols,
                        time=self.time[rows].copy(),
                        time_var=self.time_var[rows].copy(),
                        samples=self.samples[rows].copy(),
                        mask=self._mask[rows].copy(),
                        counters=counters)

    def apply_rows(self, block: RowBlock,
                   rows: Optional[np.ndarray] = None) -> None:
        """Overwrite a row subset with a :class:`RowBlock`'s state.

        Target ``rows`` default to ``block.rows`` (the aggregator replica
        case: same local indices); pass explicit rows to land the block
        at a different row range (the live-subfleet compaction).  The
        rows' prior state — entries AND counters — is fully replaced, so
        applying the same block twice is idempotent, and applying a
        host's blocks in sequence order leaves the replica bit-identical
        to the source shard.  Applied rows are marked dirty (a device
        view over this store re-uploads them)."""
        rows = block.rows if rows is None else np.asarray(rows, np.intp)
        if rows.size == 0:
            return
        self.ensure_columns(block.n_cols)
        c = block.n_cols
        old = int(np.count_nonzero(self._mask[rows]))
        self._mask[rows] = False
        self._mask[rows, :c] = block.mask
        self._count += int(np.count_nonzero(block.mask)) - old
        self.time[rows] = 0.0
        self.time[rows, :c] = block.time
        self.time_var[rows] = 0.0
        self.time_var[rows, :c] = block.time_var
        self.samples[rows] = 0
        self.samples[rows, :c] = block.samples
        self._dirty[rows] = True
        for cc in self._counters.values():
            k = len(cc.vids)
            cc.values[rows, :k] = 0.0
            cc.mask[rows, :k] = False
        for name, (vids, values, mask) in block.counters.items():
            cc = self._counter_cols(name)
            slots = np.asarray([cc.slot(v) for v in vids.tolist()], np.intp)
            cc.values[np.ix_(rows, slots)] = values
            cc.mask[np.ix_(rows, slots)] = mask

    # -- whole-store state (the ONE persistence seam) ------------------
    TREE_FORMAT = "perfstore"
    TREE_VERSION = 1

    def to_tree(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tree, meta): the store's full state as plain numpy arrays.

        ``tree`` is a nested dict (checkpoint-friendly pytree) of
        copies, counters column-sparse; ``meta`` holds the
        JSON-serializable layout (versioned format header, row/column
        counts, counter names by index).  Together they round-trip
        through :meth:`load_tree` / :meth:`from_tree` bit-identically.
        This is the single persistence path: the monitor's crash
        snapshot and the run store both write one ``to_tree()`` per
        store/shard through the JAX package's ``repro.checkpoint.store``.
        """
        names = list(self._counters)
        tree: Dict[str, Any] = {
            "time": self.time.copy(), "time_var": self.time_var.copy(),
            "samples": self.samples.copy(), "mask": self._mask.copy(),
            "counters": {f"c{i}": self._counters[name].to_tree()
                         for i, name in enumerate(names)},
        }
        meta = self._tree_meta()
        meta["counter_names"] = names
        return tree, meta

    def _tree_meta(self) -> Dict[str, Any]:
        return {"format": self.TREE_FORMAT, "version": self.TREE_VERSION,
                "n_procs": int(self.n_procs), "n_cols": int(self._cols)}

    def load_tree(self, tree: Mapping[str, Any],
                  meta: Mapping[str, Any]) -> None:
        """Restore the state captured by :meth:`to_tree` into this store
        (dimensions grow as needed; prior contents are replaced).
        Restored rows are all marked dirty, so a fresh device view
        re-uploads everything on its first refresh."""
        check_tree_format(meta, self.TREE_FORMAT, self.TREE_VERSION)
        time = np.asarray(tree["time"])
        rows, cols = time.shape
        self.ensure_rows(rows)
        self.ensure_columns(cols)
        self.time[:, :] = 0.0
        self.time_var[:, :] = 0.0
        self.samples[:, :] = 0
        self._mask[:, :] = False
        self.time[:rows, :cols] = time
        self.time_var[:rows, :cols] = tree["time_var"]
        self.samples[:rows, :cols] = tree["samples"]
        self._mask[:rows, :cols] = tree["mask"]
        self._count = int(np.count_nonzero(self._mask))
        self._dirty[:] = True
        self._counters = {}
        # a store with zero counters serializes "counters" as an empty
        # dict, which some tree transports drop — counter_names is the
        # authority, so absence is only legal when it says "none"
        blocks = tree.get("counters", {})
        for i, name in enumerate(meta["counter_names"]):
            cc = self._counter_cols(name)
            cc.load_tree(blocks[f"c{i}"])

    @classmethod
    def from_tree(cls, tree: Mapping[str, Any],
                  meta: Mapping[str, Any]) -> "PerfStore":
        store = cls(int(meta["n_procs"]), int(meta["n_cols"]))
        store.load_tree(tree, meta)
        return store

    # -- shard merge (streamed multi-host assembly) --------------------
    def merge_shard(self, shard: "PerfStore") -> None:
        """Merge one per-host shard — a PerfStore whose rows map to global
        processes ``proc_start + local`` (``proc_start`` defaults to 0; see
        :class:`repro_torch.core.shard.PerfShard`).

        When the shard's contiguous row block ``[proc_start, proc_stop)``
        is still untouched in this store (the streamed-assembly common
        case: each host range lands once), the whole block copies in with
        ONE masked assignment per matrix plus one scatter per counter —
        identical entries to the grouped path, without the
        per-(vertex, counter-signature) ``set_entries`` loop.  Overlapping
        or revisited ranges fall back to :meth:`_merge_shard_grouped`, the
        retained per-signature reference, so last-writer-wins semantics
        are unchanged."""
        off = int(getattr(shard, "proc_start", 0))
        self.ensure_rows(off + shard.n_procs)
        self.ensure_columns(shard._cols)
        rows = slice(off, off + shard.n_procs)
        if not self._mask[rows].any():
            self._merge_shard_block(shard, off)
        else:
            self._merge_shard_grouped(shard, off)

    def _merge_shard_block(self, shard: "PerfStore", off: int) -> None:
        """Whole-block masked copy of one shard into untouched target rows
        — bit-identical to the grouped path (same assignments, no
        accumulation is involved because the rows carry no prior entries).
        """
        rows = slice(off, off + shard.n_procs)
        cols = shard._cols
        msk = shard._mask
        np.copyto(self.time[rows, :cols], shard.time, where=msk)
        np.copyto(self.time_var[rows, :cols], shard.time_var, where=msk)
        np.copyto(self.samples[rows, :cols], shard.samples, where=msk)
        self._mask[rows, :cols] |= msk
        self._count += int(np.count_nonzero(msk))
        self._dirty[rows] |= msk.any(axis=1)
        for name, scc in shard._counters.items():
            svids, svals, smask = scc.columns()
            if not svids.size:
                continue
            cc = self._counter_cols(name)
            slots = np.asarray([cc.slot(v) for v in svids.tolist()], np.intp)
            r, c = np.nonzero(smask)
            cc.values[off + r, slots[c]] = svals[r, c]
            cc.mask[off + r, slots[c]] = True

    def _merge_shard_grouped(self, shard: "PerfStore", off: int) -> None:
        """Per-(vertex, counter-signature) shard merge: every written
        entry lands through :meth:`set_entries` — the one write seam — as
        one batched scatter per signature group.  The reference the block
        fast path is tested against, and the fallback for overlapping
        ranges."""
        for vid in np.nonzero(shard._mask.any(axis=0))[0].tolist():
            rows = np.nonzero(shard._mask[:, vid])[0]
            named = [(name, cc, cc.slot_of[vid])
                     for name, cc in shard._counters.items()
                     if vid in cc.slot_of]
            if named:
                # rows sharing a counter signature (which counters are set
                # at this vertex) land in one set_entries call each; within
                # one shard the signature is almost always uniform
                bits = np.stack([cc.mask[rows, s] for _, cc, s in named])
                _, inv = np.unique(bits.T, axis=0, return_inverse=True)
            else:
                bits = np.zeros((0, rows.size), bool)
                inv = np.zeros(rows.size, np.intp)
            for gi in range(int(inv.max()) + 1):
                sel = inv == gi
                r = rows[sel]
                sig = bits[:, sel][:, 0] if named else ()
                counters = {name: cc.values[r, s]
                            for (name, cc, s), on in zip(named, sig) if on}
                self.set_entries(off + r, vid, shard.time[r, vid],
                                 time_var=shard.time_var[r, vid],
                                 samples=shard.samples[r, vid],
                                 counters=counters)

    @classmethod
    def assemble_streamed(cls, shards: Iterable["PerfStore"], *,
                          n_procs: int = 0, n_vertices: int = 0
                          ) -> "PerfStore":
        """Merge an iterable of per-host shards ONE AT A TIME.

        The streamed form of :meth:`from_shards`: shards are consumed from
        the iterator and merged immediately (block concatenation through
        the :meth:`set_entries` seam), so a controller never holds more
        than one shard plus the growing result — no single-controller
        gather of all hosts.  ``n_procs`` / ``n_vertices`` pre-size the
        result when known; otherwise both dimensions grow as host ranges
        stream in."""
        store = PerfStore(n_procs, n_vertices)
        for shard in shards:
            store.merge_shard(shard)
        return store

    @classmethod
    def from_shards(cls, shards: Iterable["PerfStore"], *,
                    n_procs: Optional[int] = None,
                    n_vertices: Optional[int] = None) -> "PerfStore":
        """Assemble one store from per-host shards by block concatenation.

        Shards are PerfStore-like blocks with a ``proc_start`` row offset
        (:class:`repro_torch.core.shard.PerfShard`); ranges may be uneven, may
        carry disjoint counter sets, and may overlap (later shards
        overwrite, exactly like repeated ``set_entries`` calls)."""
        shards = list(shards)
        if n_procs is None:
            n_procs = max((int(getattr(s, "proc_start", 0)) + s.n_procs
                           for s in shards), default=0)
        if n_vertices is None:
            n_vertices = max((s._cols for s in shards), default=0)
        return cls.assemble_streamed(shards, n_procs=n_procs,
                                     n_vertices=n_vertices)

    # -- mapping API (back compat) -------------------------------------
    def __setitem__(self, key: Tuple[int, int], vec: PerfVector) -> None:
        p, vid = key
        self.ensure_columns(vid + 1)
        if not self._mask[p, vid]:
            self._count += 1
        self._mask[p, vid] = True
        self._dirty[p] = True
        self.time[p, vid] = vec.time
        self.time_var[p, vid] = vec.time_var
        self.samples[p, vid] = vec.samples
        # clear stale counters — value AND mask, so counter_matrix (which
        # reads the sparse columns) never sees a leftover from the old entry
        for cc in self._counters.values():
            s = cc.slot_of.get(vid)
            if s is not None:
                cc.mask[p, s] = False
                cc.values[p, s] = 0.0
        for name, val in vec.counters.items():
            cc = self._counter_cols(name)
            s = cc.slot(vid)
            cc.values[p, s] = val
            cc.mask[p, s] = True

    def __getitem__(self, key: Tuple[int, int]) -> PerfVector:
        p, vid = key
        if vid >= self._cols or not self._mask[p, vid]:
            raise KeyError(key)
        counters = {}
        for name, cc in self._counters.items():
            s = cc.slot_of.get(vid)
            if s is not None and cc.mask[p, s]:
                counters[name] = float(cc.values[p, s])
        return PerfVector(time=float(self.time[p, vid]),
                          time_var=float(self.time_var[p, vid]),
                          samples=int(self.samples[p, vid]),
                          counters=counters)

    def get(self, key: Tuple[int, int],
            default: Optional[PerfVector] = None) -> Optional[PerfVector]:
        try:
            return self[key]
        except (KeyError, IndexError):
            return default

    def __contains__(self, key: Tuple[int, int]) -> bool:
        p, vid = key
        return vid < self._cols and bool(self._mask[p, vid])

    def __len__(self) -> int:
        return self._count

    def keys(self) -> Iterator[Tuple[int, int]]:
        for p, vid in np.argwhere(self._mask):
            yield (int(p), int(vid))

    __iter__ = keys

    def values(self) -> Iterator[PerfVector]:
        for key in self.keys():
            yield self[key]

    def items(self) -> Iterator[Tuple[Tuple[int, int], PerfVector]]:
        for key in self.keys():
            yield key, self[key]

    def counter_nbytes(self) -> int:
        """Sparse counter storage (used columns only)."""
        return sum(cc.nbytes() for cc in self._counters.values())

    def counter_dense_nbytes(self) -> int:
        """What the counters would cost as dense (n_procs, V) matrices —
        the pre-sparsification layout, for storage-win reporting."""
        per = self.n_procs * self._cols * 9        # f64 value + bool mask
        return per * len(self._counters)

    def nbytes(self) -> int:
        base = (self.time.nbytes + self.time_var.nbytes + self.samples.nbytes
                + self._mask.nbytes)
        return base + self.counter_nbytes()


class CommIndex:
    """Inter-process communication dependence, stored O(P) per collective.

    p2p edges are explicit ((proc, vid) -> (proc, vid)) with a reverse
    index; collectives are participant *groups* per vertex, from which
    clique edges are resolved lazily.  Provides the old ``comm_edges`` set
    API (membership / len / iteration) without materializing cliques.
    """

    __slots__ = ("_p2p", "_p2p_preds", "_groups", "_group_sets",
                 "_group_seen", "_p2p_batches")

    def __init__(self):
        self._p2p: Set[Tuple[Tuple[int, int], Tuple[int, int]]] = set()
        self._p2p_preds: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        self._groups: Dict[int, List[Tuple[int, ...]]] = {}
        self._group_sets: Dict[int, List[frozenset]] = {}
        # per-vid set of the groups above: O(1) duplicate checks, so a
        # vertex carrying P/2 pair groups registers in O(P), not O(P^2)
        self._group_seen: Dict[int, Set[frozenset]] = {}
        # bulk-registered (vid, src_procs, dst_procs) edge blocks, folded
        # into the explicit set/preds indexes lazily on first query — PPG
        # assembly over an 8k-pair halo ring costs one array append, not
        # 8k Python set inserts
        self._p2p_batches: List[Tuple[int, np.ndarray, np.ndarray]] = []

    # -- construction --------------------------------------------------
    def add_p2p(self, src: Tuple[int, int], dst: Tuple[int, int]) -> None:
        edge = (src, dst)
        if edge in self._p2p:
            return
        self._p2p.add(edge)
        self._p2p_preds.setdefault(dst, []).append(src)

    def add_p2p_batch(self, vid: int, src_procs, dst_procs) -> None:
        """Register p2p edges ``(src, vid) -> (dst, vid)`` in bulk, O(1)
        until first queried (then folded in registration order, with the
        same dedup as repeated :meth:`add_p2p` calls)."""
        src = np.asarray(src_procs, np.intp)
        dst = np.asarray(dst_procs, np.intp)
        if src.size:
            self._p2p_batches.append((int(vid), src, dst))

    def _materialize_p2p(self) -> None:
        if not self._p2p_batches:
            return
        batches, self._p2p_batches = self._p2p_batches, []
        for vid, src, dst in batches:
            for s, d in zip(src.tolist(), dst.tolist()):
                self.add_p2p((s, vid), (d, vid))

    def add_group(self, vid: int, procs: Sequence[int]) -> None:
        group = tuple(procs)
        if len(group) < 2:
            return
        gs = frozenset(group)
        seen = self._group_seen.setdefault(vid, set())
        if gs in seen:
            return
        seen.add(gs)
        self._groups.setdefault(vid, []).append(group)
        self._group_sets.setdefault(vid, []).append(gs)

    # -- queries -------------------------------------------------------
    def groups_of(self, vid: int) -> List[Tuple[int, ...]]:
        return list(self._groups.get(vid, ()))

    def group_of(self, proc: int, vid: int) -> Optional[Tuple[int, ...]]:
        """The participant group containing ``proc`` at ``vid`` (if any)."""
        for group, gs in zip(self._groups.get(vid, ()),
                             self._group_sets.get(vid, ())):
            if proc in gs:
                return group
        return None

    def partners(self, proc: int, vid: int) -> List[Tuple[int, int]]:
        """Reverse-edge sources of (proc, vid): p2p preds + peers from
        EVERY group containing proc (deduplicated, like the old edge set —
        a vertex can carry several groups, e.g. staged collectives)."""
        self._materialize_p2p()
        out = list(self._p2p_preds.get((proc, vid), ()))
        seen = set(out)
        for group, gs in zip(self._groups.get(vid, ()),
                             self._group_sets.get(vid, ())):
            if proc not in gs:
                continue
            for q in group:
                if q != proc and (q, vid) not in seen:
                    seen.add((q, vid))
                    out.append((q, vid))
        return out

    def p2p_preds_of(self, dst: Tuple[int, int]) -> List[Tuple[int, int]]:
        """Explicit p2p reverse-edge sources of ``dst`` in registration
        order (the internal list — treat as read-only).  The batched
        backtracker's per-node gather; ``partners`` additionally resolves
        collective group peers."""
        self._materialize_p2p()
        return self._p2p_preds.get(dst, [])

    def has_groups(self, vid: int) -> bool:
        return bool(self._groups.get(vid))

    def p2p_edges(self) -> Set[Tuple[Tuple[int, int], Tuple[int, int]]]:
        self._materialize_p2p()
        return self._p2p

    # -- set-compatible view -------------------------------------------
    def __contains__(self, edge) -> bool:
        try:
            (sp, sv), (dp, dv) = edge
        except (TypeError, ValueError):
            return False
        self._materialize_p2p()
        if (tuple(edge[0]), tuple(edge[1])) in self._p2p:
            return True
        if sv != dv or sp == dp:
            return False
        for gs in self._group_sets.get(dv, ()):
            if sp in gs and dp in gs:
                return True
        return False

    def __len__(self) -> int:
        self._materialize_p2p()
        n = len(self._p2p)
        for groups in self._groups.values():
            n += sum(len(g) * (len(g) - 1) for g in groups)
        return n

    def __iter__(self):
        """Lazily generated edges — O(P²) to exhaust for a clique; use
        ``partners``/``groups_of`` in hot paths."""
        self._materialize_p2p()
        yield from self._p2p
        for vid, groups in self._groups.items():
            for g in groups:
                for i in g:
                    for j in g:
                        if i != j:
                            yield ((i, vid), (j, vid))

    def nbytes(self) -> int:
        """O(P) comm-dependence storage: 16B per explicit p2p edge + 8B per
        collective participant (vs 16B x |g|² for a materialized clique)."""
        self._materialize_p2p()
        n = 16 * len(self._p2p)
        for groups in self._groups.values():
            n += sum(8 * len(g) for g in groups)
        return n

    # -- checkpoint-tree seam ------------------------------------------
    def to_tree(self) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """(tree, meta): the O(P) comm index as flat int64 arrays.

        p2p edges become one (n, 4) ``[sp, sv, dp, dv]`` block (sorted,
        so the tree is a canonical form of the edge SET); collective
        groups become a ragged (vid, size, flat-members) triple in
        per-vid registration order.  Cliques are never materialized.
        """
        self._materialize_p2p()
        p2p = np.asarray(
            [[sp, sv, dp, dv] for (sp, sv), (dp, dv) in sorted(self._p2p)],
            np.int64).reshape(-1, 4)
        vids: List[int] = []
        sizes: List[int] = []
        members: List[int] = []
        for vid in sorted(self._groups):
            for group in self._groups[vid]:
                vids.append(vid)
                sizes.append(len(group))
                members.extend(group)
        tree = {"p2p": p2p,
                "group_vids": np.asarray(vids, np.int64),
                "group_sizes": np.asarray(sizes, np.int64),
                "group_members": np.asarray(members, np.int64)}
        return tree, {"format": "commindex", "version": 1}

    @classmethod
    def from_tree(cls, tree: Mapping[str, Any],
                  meta: Optional[Mapping[str, Any]] = None) -> "CommIndex":
        check_tree_format(meta, "commindex", 1)
        ci = cls()
        p2p = np.asarray(tree["p2p"], np.int64).reshape(-1, 4)
        for sp, sv, dp, dv in p2p.tolist():
            # rows are pre-deduplicated (serialized from a set), so the
            # add_p2p membership probe is skipped
            edge = ((sp, sv), (dp, dv))
            ci._p2p.add(edge)
            ci._p2p_preds.setdefault(edge[1], []).append(edge[0])
        vids = np.asarray(tree["group_vids"], np.int64).tolist()
        sizes = np.asarray(tree["group_sizes"], np.int64).tolist()
        members = np.asarray(tree["group_members"], np.int64).tolist()
        off = 0
        for vid, size in zip(vids, sizes):
            ci.add_group(vid, members[off:off + size])
            off += size
        return ci


class PPG:
    """Program performance graph: the PSG replicated across ``n_procs``
    SPMD processes + inter-process communication dependence + perf data.

    PPG vertex id = (proc, vid).  Perf data lives in a :class:`PerfStore`
    (dense time/var/sample matrices, column-sparse counters); collective
    comm dependence is implicit (participant groups in a
    :class:`CommIndex`), p2p edges explicit.
    """

    def __init__(self, psg: PSG, n_procs: int,
                 perf: Optional[PerfStore] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.psg = psg
        self.n_procs = int(n_procs)
        self.perf = perf if perf is not None else \
            PerfStore(n_procs, len(psg.vertices))
        self.comm = CommIndex()
        self.meta: Dict[str, Any] = dict(meta or {})
        self._device_view = None

    # -- perf ----------------------------------------------------------
    def set_perf(self, proc: int, vid: int, vec: PerfVector) -> None:
        self.perf[(proc, vid)] = vec

    def get_time(self, proc: int, vid: int) -> float:
        return self.perf.time_at(proc, vid)

    def times_across_procs(self, vid: int) -> List[float]:
        return self.perf.time_column(vid).tolist()

    def times_matrix(self) -> np.ndarray:
        """(n_procs, n_vertices) time matrix — the detectors' input.  For a
        sharded perf store this is the stacked shard view (per-host blocks
        concatenated, never scattered through a merged store)."""
        return self.perf.time_matrix(len(self.psg.vertices))

    def var_matrix(self) -> np.ndarray:
        """(n_procs, n_vertices) time-variance matrix (zero where unset) —
        input to the variance-weighted ("var") merge strategy."""
        return self.perf.var_matrix(len(self.psg.vertices))

    def device_view(self, device=None):
        """This PPG's cached :class:`~repro_torch.core.shard.TorchShardView`
        — the perf store's per-host blocks pinned as torch tensors on
        ``device`` (default ``cuda``) with dirty-row incremental upload.
        Created lazily (the graph layer imports torch only here); the
        torch detectors feed from it so a ShardedStore-backed PPG never
        materializes the stacked (P, V) host matrix.  Asking for another
        device replaces the cached view (the new one re-pins in full)."""
        from repro_torch.core.shard import TorchShardView
        want = TorchShardView.resolve_device(device)
        if self._device_view is None or self._device_view.device != want:
            self._device_view = TorchShardView(self.perf, device=want)
        return self._device_view

    def counter_matrix(self, name: str) -> np.ndarray:
        return self.perf.counter_matrix(name, len(self.psg.vertices))

    # -- comm dependence ------------------------------------------------
    @property
    def comm_edges(self) -> CommIndex:
        """Set-like view of all comm edges (cliques resolved lazily)."""
        return self.comm

    def add_collective_edges(self, vid: int,
                             procs: Optional[Sequence[int]] = None) -> None:
        """Register the participant group (implicit clique, O(|group|))."""
        procs = range(self.n_procs) if procs is None else procs
        self.comm.add_group(vid, list(procs))

    def add_p2p_edge(self, src_proc: int, src_vid: int,
                     dst_proc: int, dst_vid: int) -> None:
        self.comm.add_p2p((src_proc, src_vid), (dst_proc, dst_vid))

    def comm_partners(self, proc: int, vid: int) -> List[Tuple[int, int]]:
        """Processes/vertices this (proc, vid) depends on (reverse edges)."""
        return self.comm.partners(proc, vid)

    def nbytes(self) -> int:
        return self.psg.nbytes() + self.perf.nbytes() + self.comm.nbytes()

    # -- checkpoint-tree seam ------------------------------------------
    def to_tree(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tree, meta): PSG + perf store + comm index as one pytree.

        The perf component serializes through whatever store backs this
        PPG — a plain :class:`PerfStore` or a
        :class:`~repro_torch.core.shard.ShardedStore` (its meta ``format``
        records which, and :meth:`from_tree` rebuilds the same kind).
        """
        psg_tree, psg_meta = self.psg.to_tree()
        perf_tree, perf_meta = self.perf.to_tree()
        comm_tree, comm_meta = self.comm.to_tree()
        tree = {"psg": psg_tree, "perf": perf_tree, "comm": comm_tree}
        meta = {"format": "ppg", "version": 1,
                "n_procs": int(self.n_procs),
                "psg": psg_meta, "perf": perf_meta, "comm": comm_meta}
        return tree, meta

    @classmethod
    def from_tree(cls, tree: Mapping[str, Any],
                  meta: Mapping[str, Any]) -> "PPG":
        check_tree_format(meta, "ppg", 1)
        psg = PSG.from_tree(tree["psg"], meta.get("psg"))
        perf_meta = meta["perf"]
        if perf_meta.get("format") == "shardedstore":
            from repro_torch.core.shard import ShardedStore
            perf = ShardedStore.from_tree(tree["perf"], perf_meta)
        else:
            perf = PerfStore.from_tree(tree["perf"], perf_meta)
        ppg = cls(psg, int(meta["n_procs"]), perf)
        ppg.comm = CommIndex.from_tree(tree["comm"], meta.get("comm"))
        return ppg

"""Sharded performance-data layer: per-host PerfStore blocks.

The PPG's perf data no longer has to be assembled by a single controller:
each host records its own proc-range block (:class:`PerfShard` — a
:class:`~repro_torch.core.graph.PerfStore` whose rows are local processes offset
by ``proc_start``), and the blocks merge late, either

* into one global store — ``PerfStore.from_shards(shards)`` /
  ``PerfStore.assemble_streamed(shards)`` concatenate the blocks through
  the ``set_entries`` write seam, bit-identical to single-store assembly —
  or
* not at all — :class:`ShardedStore` keeps the per-host blocks and serves
  the PerfStore API on top: writes route to the owning shard by proc
  range, matrix reads are STACKED VIEWS (per-shard blocks concatenated on
  demand), so the detectors consume multi-host data without ever
  densifying it into a merged store.

``repro_torch.core.inject.simulate(..., shards=...)`` executes the replay engine
straight into a ShardedStore (multi-host replay), and
``GraphProfiler.perf_shard`` emits a measured per-host block; both feed
``build_ppg`` unchanged.

:class:`TorchShardView` closes the online-detection loop: it pins the
per-host blocks as torch tensors on a device (``cuda`` unless the caller
asks for the CPU) with dirty-row incremental upload, so the torch
detectors consume device-resident inputs instead of a re-stacked,
re-transferred host matrix on every call.  This module itself never
imports torch (the view imports it lazily).
"""
from __future__ import annotations

from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.graph import PerfStore, PerfVector


def shard_ranges(n_procs: int, n_hosts: int) -> List[Tuple[int, int]]:
    """Split ``[0, n_procs)`` into ``n_hosts`` contiguous (start, stop)
    ranges, as even as possible (first ranges take the remainder).

    ``n_procs == 0`` is an explicit error: the empty store has no valid
    tiling (:class:`ShardedStore` rejects empty ranges), so callers that
    might shard zero processes fail loudly here instead of at the store."""
    n_procs, n_hosts = int(n_procs), int(n_hosts)
    if n_hosts <= 0:
        raise ValueError(f"n_hosts must be positive: {n_hosts}")
    if n_procs <= 0:
        raise ValueError(f"cannot shard {n_procs} processes: ranges must "
                         f"tile a non-empty [0, n_procs)")
    n_hosts = min(n_hosts, n_procs)
    base, rem = divmod(n_procs, n_hosts)
    out, lo = [], 0
    for h in range(n_hosts):
        hi = lo + base + (1 if h < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


class PerfShard(PerfStore):
    """One host's proc-range block of a PerfStore.

    Rows are LOCAL processes; row ``i`` is global process
    ``proc_start + i``.  Everything else — dense time/var/sample matrices,
    column-sparse counters, the ``set_entries`` seam — is the plain
    :class:`PerfStore` layout, so a shard is just a store that knows where
    its rows land in the global proc space.
    """

    __slots__ = ("proc_start",)

    def __init__(self, proc_start: int, n_procs: int, n_vertices: int = 0):
        super().__init__(n_procs, n_vertices)
        self.proc_start = int(proc_start)

    @property
    def proc_stop(self) -> int:
        return self.proc_start + self.n_procs

    def to_local(self, procs) -> np.ndarray:
        """Global proc indices -> this shard's local row indices."""
        return np.asarray(procs, np.intp) - self.proc_start

    def _tree_meta(self) -> Dict[str, Any]:
        meta = super()._tree_meta()
        meta["proc_start"] = int(self.proc_start)
        return meta

    @classmethod
    def from_tree(cls, tree: Mapping[str, Any],
                  meta: Mapping[str, Any]) -> "PerfShard":
        shard = cls(int(meta.get("proc_start", 0)),
                    int(meta["n_procs"]), int(meta["n_cols"]))
        shard.load_tree(tree, meta)
        return shard

    def __repr__(self) -> str:
        return (f"PerfShard([{self.proc_start}, {self.proc_stop}), "
                f"{len(self)} entries)")


class ShardedStore:
    """Per-host :class:`PerfShard` blocks behind the PerfStore API.

    Writes (``set_column`` / ``set_entries`` / ``set_entry``) route each
    proc index to the shard owning its range — a row's writes keep their
    order, so accumulate-mode scatters are bit-identical to the unsharded
    store.  Matrix reads (``time_matrix`` / ``var_matrix`` /
    ``counter_columns``) are stacked shard views: per-host blocks
    concatenated on demand, never scattered into a merged store.  Use
    :meth:`merge` when a genuinely single store is needed.

    Ranges must tile ``[0, n_procs)`` contiguously (the replay engine
    writes every process).
    """

    __slots__ = ("shards", "n_procs", "_starts")

    def __init__(self, ranges: Sequence[Tuple[int, int]], n_vertices: int = 0):
        ranges = [(int(lo), int(hi)) for lo, hi in ranges]
        if not ranges:
            raise ValueError("ShardedStore needs at least one range")
        lo0 = 0
        for lo, hi in ranges:
            if lo != lo0 or hi <= lo:
                raise ValueError(f"ranges must tile [0, P) contiguously: "
                                 f"{ranges}")
            lo0 = hi
        self.shards: List[PerfShard] = [PerfShard(lo, hi - lo, n_vertices)
                                        for lo, hi in ranges]
        self.n_procs = ranges[-1][1]
        self._starts = np.asarray([lo for lo, _ in ranges], np.intp)

    @classmethod
    def of(cls, shards) -> "ShardedStore":
        """Adopt existing :class:`PerfShard` blocks AS the store (no copy,
        no merge) — e.g. per-host measured blocks from
        ``GraphProfiler.perf_shard``.  The blocks' ranges must tile
        ``[0, n_procs)`` contiguously; hosts may report in any order
        (blocks are sorted by range, like the streamed merge accepts any
        arrival order)."""
        shards = sorted(shards, key=lambda s: s.proc_start)
        store = cls([(s.proc_start, s.proc_stop) for s in shards])
        store.shards = shards
        return store

    # -- routing -------------------------------------------------------
    def shard_of(self, proc: int) -> PerfShard:
        """The shard owning global process ``proc``."""
        i = int(np.searchsorted(self._starts, proc, side="right")) - 1
        return self.shards[i]

    def _route(self, procs: np.ndarray) -> Iterator[Tuple[PerfShard,
                                                          np.ndarray]]:
        """Yield (shard, selector) for each shard with rows in ``procs``;
        selectors preserve the original order of a row's occurrences."""
        sidx = np.searchsorted(self._starts, procs, side="right") - 1
        for i in np.unique(sidx).tolist():
            yield self.shards[i], sidx == i

    # -- write API (the replay engine's surface) -----------------------
    def ensure_columns(self, n_vertices: int) -> None:
        for sh in self.shards:
            sh.ensure_columns(n_vertices)

    def set_column(self, vid: int, time, *, time_var=0.0, samples=1,
                   counters: Optional[Mapping[str, Any]] = None,
                   procs: Optional[np.ndarray] = None) -> None:
        if procs is not None:
            procs = np.asarray(procs, np.intp)
            if procs.size == 0:
                return
            for sh, sel in self._route(procs):
                local = procs[sel] - sh.proc_start
                sh.set_column(vid, _take(time, sel), procs=local,
                              time_var=_take(time_var, sel),
                              samples=_take(samples, sel),
                              counters={k: _take(v, sel)
                                        for k, v in (counters or {}).items()})
            return
        for sh in self.shards:
            blk = slice(sh.proc_start, sh.proc_stop)
            sh.set_column(vid, _slice(time, blk),
                          time_var=_slice(time_var, blk),
                          samples=_slice(samples, blk),
                          counters={k: _slice(v, blk)
                                    for k, v in (counters or {}).items()})

    def set_entries(self, procs, vid: int, time, *, time_var=0.0, samples=1,
                    counters: Optional[Mapping[str, Any]] = None,
                    accumulate: bool = False) -> None:
        procs = np.asarray(procs, np.intp)
        if procs.size == 0:
            return
        t = np.broadcast_to(np.asarray(time, float), procs.shape)
        tv = np.broadcast_to(np.asarray(time_var), procs.shape)
        sm = np.broadcast_to(np.asarray(samples), procs.shape)
        cs = {k: np.broadcast_to(np.asarray(v, float), procs.shape)
              for k, v in (counters or {}).items()}
        for sh, sel in self._route(procs):
            sh.set_entries(procs[sel] - sh.proc_start, vid, t[sel],
                           time_var=tv[sel], samples=sm[sel],
                           counters={k: v[sel] for k, v in cs.items()},
                           accumulate=accumulate)

    def set_entry(self, p: int, vid: int, time: float, *, time_var=0.0,
                  samples=1, counters: Optional[Mapping[str, float]] = None,
                  accumulate: bool = False) -> None:
        sh = self.shard_of(p)
        sh.set_entry(p - sh.proc_start, vid, time, time_var=time_var,
                     samples=samples, counters=counters,
                     accumulate=accumulate)

    def __setitem__(self, key: Tuple[int, int], vec: PerfVector) -> None:
        p, vid = key
        sh = self.shard_of(p)
        sh[(p - sh.proc_start, vid)] = vec

    # -- stacked read views --------------------------------------------
    @property
    def _cols(self) -> int:
        return max(sh._cols for sh in self.shards)

    def time_matrix(self, n_vertices: Optional[int] = None) -> np.ndarray:
        n = self._cols if n_vertices is None else n_vertices
        return np.vstack([sh.time_matrix(n) for sh in self.shards])

    def var_matrix(self, n_vertices: Optional[int] = None) -> np.ndarray:
        n = self._cols if n_vertices is None else n_vertices
        return np.vstack([sh.var_matrix(n) for sh in self.shards])

    def counter_matrix(self, name: str,
                       n_vertices: Optional[int] = None) -> np.ndarray:
        n = self._cols if n_vertices is None else n_vertices
        return np.vstack([sh.counter_matrix(name, n) for sh in self.shards])

    def counter_columns(self, name: str
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stacked compressed view: the union of the shards' written
        columns, each shard's block placed at its row range."""
        per = [sh.counter_columns(name) for sh in self.shards]
        vids = np.unique(np.concatenate([v for v, _, _ in per]))
        values = np.zeros((self.n_procs, vids.size))
        mask = np.zeros((self.n_procs, vids.size), bool)
        for sh, (v, val, m) in zip(self.shards, per):
            if not v.size:
                continue
            slots = np.searchsorted(vids, v)
            values[sh.proc_start:sh.proc_stop, slots] = val
            mask[sh.proc_start:sh.proc_stop, slots] = m
        return vids, values, mask

    def time_column(self, vid: int) -> np.ndarray:
        return np.concatenate([sh.time_column(vid) for sh in self.shards])

    def time_at(self, p: int, vid: int) -> float:
        sh = self.shard_of(p)
        return sh.time_at(p - sh.proc_start, vid)

    def counter_at(self, name: str, p: int, vid: int,
                   default: float = 0.0) -> float:
        sh = self.shard_of(p)
        return sh.counter_at(name, p - sh.proc_start, vid, default)

    def counter_names(self) -> List[str]:
        seen: Dict[str, None] = {}
        for sh in self.shards:
            for name in sh.counter_names():
                seen.setdefault(name)
        return list(seen)

    # -- mapping API (back compat) -------------------------------------
    def __getitem__(self, key: Tuple[int, int]) -> PerfVector:
        p, vid = key
        sh = self.shard_of(p)
        return sh[(p - sh.proc_start, vid)]

    def get(self, key: Tuple[int, int],
            default: Optional[PerfVector] = None) -> Optional[PerfVector]:
        try:
            return self[key]
        except (KeyError, IndexError):
            return default

    def __contains__(self, key: Tuple[int, int]) -> bool:
        p, vid = key
        sh = self.shard_of(p)
        return (p - sh.proc_start, vid) in sh

    def __len__(self) -> int:
        return sum(len(sh) for sh in self.shards)

    def keys(self) -> Iterator[Tuple[int, int]]:
        for sh in self.shards:
            for p, vid in sh.keys():
                yield (p + sh.proc_start, vid)

    __iter__ = keys

    def values(self) -> Iterator[PerfVector]:
        for key in self.keys():
            yield self[key]

    def items(self) -> Iterator[Tuple[Tuple[int, int], PerfVector]]:
        for key in self.keys():
            yield key, self[key]

    # -- storage / merge -----------------------------------------------
    def counter_nbytes(self) -> int:
        return sum(sh.counter_nbytes() for sh in self.shards)

    def counter_dense_nbytes(self) -> int:
        return sum(sh.counter_dense_nbytes() for sh in self.shards)

    def nbytes(self) -> int:
        return sum(sh.nbytes() for sh in self.shards)

    def merge(self) -> PerfStore:
        """Concatenate the blocks into one global PerfStore (the
        ``from_shards`` seam)."""
        return PerfStore.from_shards(self.shards, n_procs=self.n_procs)

    # -- checkpoint-tree seam ------------------------------------------
    def to_tree(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tree, meta): every per-host block through the one
        :meth:`PerfStore.to_tree` seam — the sharded layout (ranges,
        per-shard metas) lives in meta, so a reload rebuilds the same
        blocks without merging or densifying anything."""
        tree: Dict[str, Any] = {"shards": {}}
        shard_meta = []
        for i, sh in enumerate(self.shards):
            sh_tree, sh_meta = sh.to_tree()
            tree["shards"][f"s{i}"] = sh_tree
            shard_meta.append(sh_meta)
        meta = {"format": "shardedstore", "version": 1,
                "n_procs": int(self.n_procs),
                "ranges": [[sh.proc_start, sh.proc_stop]
                           for sh in self.shards],
                "shards": shard_meta}
        return tree, meta

    @classmethod
    def from_tree(cls, tree: Mapping[str, Any],
                  meta: Mapping[str, Any]) -> "ShardedStore":
        from repro_torch.core.graph import check_tree_format
        check_tree_format(meta, "shardedstore", 1)
        shards = [PerfShard.from_tree(tree["shards"][f"s{i}"], sh_meta)
                  for i, sh_meta in enumerate(meta["shards"])]
        return cls.of(shards)


class TorchShardView:
    """Per-host perf blocks pinned as torch tensors on a device, kept up to
    date incrementally.

    :class:`ShardedStore` keeps the (P, V) time matrix as per-host blocks
    on the HOST; re-assembling and re-transferring the whole stacked
    matrix on every detect would make each call O(P · V) in transfer.  A
    view pins each block — time, time-variance, and the column-sparse
    counter blocks — as tensors on ``device`` once, then :meth:`refresh`
    re-uploads only the rows written since the last refresh (the store's
    dirty-row tracking, see :meth:`~repro_torch.core.graph.PerfStore.
    dirty_rows`), so the steady-state per-detect transfer is
    O(dirty rows · V).

    ``device`` defaults to ``cuda`` (and raises where there is no card);
    the CPU must be asked for with ``device="cpu"``.

    Buffer lifecycle:

    * construction stores only host references — no transfer;
    * the first :meth:`refresh` uploads every block in full and clears
      the dirty flags;
    * subsequent refreshes upload ``store.dirty_rows()`` per block and
      write them into the pinned tensors with ``index_copy_``; a changed
      column count, row count, dtype, or counter layout re-pins the
      affected buffers in full;
    * ``time_blocks()`` / ``var_blocks()`` hand the torch detectors the
      per-block device tensors — only (V,)-sized results ever come back
      to the host.

    Failure semantics.  Full re-pins are STAGED: new tensors build up in
    local lists and commit — together with the stores' dirty-flag clears
    — only after every transfer succeeded, so a failed first refresh
    leaves the view unprimed.  Dirty-row uploads write IN PLACE
    (``index_copy_``), so a refresh that fails after a block was written
    may leave some pinned rows newer than the last commit.  To keep that
    safe, the view bumps ``revision`` and drops the merged-column cache
    BEFORE its first in-place write, and clears the dirty flags only after
    every block succeeded: a stale merged column is never served, and the
    retry re-uploads every row the failed call was asked to carry.

    One view per store: refresh consumes the store's dirty flags, so two
    views over the same store would starve each other (``PPG.device_view``
    caches exactly one).

    Two seams serve the fused detectors
    (``repro_torch.kernels.detect_fused``):

    * ``revision`` increments once for every refresh that changed device
      data (any dirty-row or full upload).  ``merged_column()`` /
      ``cache_merged_column()`` key a device-resident (4, V) merged
      column on (revision, columns, dtype) — historical scales are
      immutable once their run completes, so their merge runs ONCE and
      the cached column feeds every later detect; any write, re-pin,
      layout or dtype change invalidates it.
    * ``kernel_launches`` counts detection launches fed from this view
      (bumped by the ``detect_torch`` entry points).
    """

    __slots__ = ("blocks", "device", "_time", "_var", "_counters", "_cols",
                 "_dtype", "last_upload_rows", "last_upload_bytes",
                 "total_upload_bytes", "refreshes", "full_uploads",
                 "revision", "kernel_launches", "_merged_cache")

    def __init__(self, store, device=None):
        if isinstance(store, ShardedStore):
            self.blocks: List[PerfStore] = list(store.shards)
        elif isinstance(store, PerfStore):
            self.blocks = [store]
        else:
            raise TypeError(f"TorchShardView needs a PerfStore or "
                            f"ShardedStore: {type(store).__name__}")
        self.device = self.resolve_device(device)
        self._time: Optional[list] = None      # per-block device tensors
        self._var: Optional[list] = None
        self._counters: Optional[list] = None  # per-block {name: (vids, buf)}
        self._cols = -1
        self._dtype: Optional[np.dtype] = None
        self.last_upload_rows = 0
        self.last_upload_bytes = 0
        self.total_upload_bytes = 0
        self.refreshes = 0
        self.full_uploads = 0
        self.revision = 0
        self.kernel_launches = 0
        self._merged_cache: Optional[tuple] = None

    @staticmethod
    def resolve_device(device=None):
        """``None`` -> ``cuda``; a bare ``cuda`` pins the current card.
        Raises where CUDA is asked for and there is no card."""
        import torch
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchShardView: no CUDA device; pass device='cpu' to "
                    "pin the blocks on the host")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    @property
    def n_procs(self) -> int:
        return sum(b.n_procs for b in self.blocks)

    def row_ranges(self) -> List[Tuple[int, int]]:
        """Each block's (start, stop) global proc range, in block order."""
        out, lo = [], 0
        for b in self.blocks:
            start = int(getattr(b, "proc_start", lo))
            out.append((start, start + b.n_procs))
            lo = start + b.n_procs
        return out

    # -- upload --------------------------------------------------------
    def _rows_slab(self, mat: np.ndarray, rows, V: int,
                   dtype: np.dtype) -> np.ndarray:
        """``mat[rows]`` padded/sliced to V columns, in ``dtype``.

        The dtype is passed in rather than read from ``self._dtype``
        because refresh commits the view dtype only after every upload
        succeeded — mid-refresh, ``self._dtype`` is still the OLD one."""
        n = mat.shape[1]
        if n >= V:
            slab = mat[rows, :V]
        else:
            slab = np.zeros((len(rows), V))
            slab[:, :n] = mat[rows]
        return np.ascontiguousarray(slab, dtype)

    def _upload(self, arr: np.ndarray):
        """A host array as a NEW tensor on the view's device (never an
        alias of host memory, even on the CPU)."""
        import torch
        return torch.from_numpy(arr).to(self.device, copy=True)

    def refresh(self, n_vertices: Optional[int] = None,
                dtype=np.float64) -> int:
        """Bring the device buffers up to date; returns bytes uploaded.

        ``n_vertices`` fixes the column count every block is padded or
        sliced to (defaults to the widest block).  ``dtype`` is the buffer
        precision, float64 or float32."""
        dtype = np.dtype(dtype)
        if dtype not in (np.dtype(np.float64), np.dtype(np.float32)):
            raise TypeError(f"TorchShardView: unsupported dtype {dtype}")
        if n_vertices is None:
            n_vertices = max(b._cols for b in self.blocks)
        V = int(n_vertices)
        full = (self._time is None or self._cols != V
                or self._dtype != dtype
                or any(buf.shape[0] != b.n_procs
                       for buf, b in zip(self._time, self.blocks)))
        rows_up = bytes_up = 0
        bumped = False
        if full:
            new_time, new_var, new_counters = [], [], []
            for b in self.blocks:
                every = np.arange(b.n_procs)
                t = self._rows_slab(b.time, every, V, dtype)
                v = self._rows_slab(b.time_var, every, V, dtype)
                new_time.append(self._upload(t))
                new_var.append(self._upload(v))
                rows_up += b.n_procs
                bytes_up += t.nbytes + v.nbytes
                pinned = {}
                for name in b.counter_names():
                    vids, values, mask = b.counter_columns(name)
                    slab = np.ascontiguousarray(
                        np.where(mask, values, 0.0), dtype)
                    pinned[name] = (tuple(vids.tolist()), self._upload(slab))
                    bytes_up += slab.nbytes
                new_counters.append(pinned)
            self._time, self._var = new_time, new_var
            self._counters = new_counters
            self.full_uploads += 1
            for b in self.blocks:
                b.clear_dirty()
        else:
            import torch
            new_counters = [dict(p) for p in self._counters]
            touched = []
            for i, b in enumerate(self.blocks):
                rows = b.dirty_rows()
                if not rows.size:
                    continue
                touched.append(b)
                t = self._rows_slab(b.time, rows, V, dtype)
                v = self._rows_slab(b.time_var, rows, V, dtype)
                writes = [(self._time[i], t), (self._var[i], v)]
                pinned = new_counters[i]
                for name in b.counter_names():
                    vids, values, mask = b.counter_columns(name)
                    key = tuple(vids.tolist())
                    have = pinned.get(name)
                    if have is not None and have[0] == key:
                        slab = np.ascontiguousarray(
                            np.where(mask[rows], values[rows], 0.0), dtype)
                        writes.append((have[1], slab))
                    else:       # new counter / new columns: re-pin
                        slab = np.ascontiguousarray(
                            np.where(mask, values, 0.0), dtype)
                        pinned[name] = (key, self._upload(slab))
                    bytes_up += slab.nbytes
                idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
                staged = [(buf, self._upload(s)) for buf, s in writes]
                if not bumped:              # before the first in-place write
                    self.revision += 1
                    self._merged_cache = None
                    bumped = True
                for buf, src in staged:
                    buf.index_copy_(0, idx, src)
                rows_up += rows.size
                bytes_up += t.nbytes + v.nbytes
            self._counters = new_counters
            for b in touched:
                b.clear_dirty()
        self._cols, self._dtype = V, dtype
        if (full or rows_up) and not bumped:
            self.revision += 1
        self.last_upload_rows = rows_up
        self.last_upload_bytes = bytes_up
        self.total_upload_bytes += bytes_up
        self.refreshes += 1
        return bytes_up

    # -- device reads (what the torch detectors consume) ---------------
    def time_blocks(self) -> list:
        """Per-block (n_local, V) device time matrices, in row order."""
        if self._time is None:
            raise RuntimeError("TorchShardView.refresh() before reading")
        return list(self._time)

    def var_blocks(self) -> list:
        if self._var is None:
            raise RuntimeError("TorchShardView.refresh() before reading")
        return list(self._var)

    def merged_column(self):
        """The cached (4, V) merged column, or None if stale/absent.

        Valid only while nothing about the device data changed since
        :meth:`cache_merged_column`: same revision (no dirty-row or full
        upload), same column count, same dtype.  Completed scales never
        write again, so their cache hits on every steady-state detect;
        the live scale's misses by construction."""
        cached = self._merged_cache
        if cached is None:
            return None
        rev, cols, dtype, col = cached
        if (rev != self.revision or cols != self._cols
                or dtype != self._dtype):
            return None
        return col

    def cache_merged_column(self, col) -> None:
        """Pin ``col`` (a (4, V) device tensor) as this view's merged
        column for the CURRENT (revision, columns, dtype) state."""
        self._merged_cache = (self.revision, self._cols, self._dtype, col)

    def counter_blocks(self, name: str) -> List[Tuple[Tuple[int, ...], Any]]:
        """Per-block ``(vids, (n_local, k) device values)`` for one
        counter (masked-off entries are 0.0); empty vids where a block
        never wrote it."""
        if self._counters is None:
            raise RuntimeError("TorchShardView.refresh() before reading")
        return [pinned.get(name, ((), None)) for pinned in self._counters]

    def __repr__(self) -> str:
        state = "unpinned" if self._time is None else \
            f"{self._cols} cols, {np.dtype(self._dtype).name}"
        return (f"TorchShardView({len(self.blocks)} blocks, "
                f"{self.n_procs} procs, {self.device}, {state})")


def _take(val, sel: np.ndarray):
    """Index broadcastable-or-scalar ``val`` by a boolean selector."""
    arr = np.asarray(val)
    return arr[sel] if arr.ndim else val


def _slice(val, blk: slice):
    arr = np.asarray(val)
    return arr[blk] if arr.ndim else val

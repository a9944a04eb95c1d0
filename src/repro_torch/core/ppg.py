"""PPG assembly: per-process PSG replicas + perf vectors + comm edges."""
from __future__ import annotations

from collections.abc import Mapping as ABCMapping
from typing import (Dict, Iterable, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.core.commdep import add_comm_edges
from repro_torch.core.graph import PPG, PSG, PerfStore, PerfVector
from repro_torch.core.shard import ShardedStore

PerfByProc = Mapping[int, Mapping[int, PerfVector]]
PerfInput = Union[Mapping[int, PerfVector], "PerfByProc", PerfStore,
                  Iterable[PerfStore]]


def _store_by_proc(store: PerfStore, perf: "PerfByProc") -> None:
    """Land {proc: {vid: PerfVector}} data as batched column scatters.

    Entries are grouped by (vid, counter-name set) and written with one
    :meth:`PerfStore.set_entries` call per group — the same seam a
    streamed per-host shard merge uses — instead of one mapping-API write
    per (proc, vid)."""
    by_vid: Dict[int, List[Tuple[int, PerfVector]]] = {}
    for p, d in perf.items():
        for vid, vec in d.items():
            by_vid.setdefault(vid, []).append((p, vec))
    for vid, entries in by_vid.items():
        groups: Dict[Tuple[str, ...], List[Tuple[int, PerfVector]]] = {}
        for p, vec in entries:
            groups.setdefault(tuple(sorted(vec.counters)), []).append((p, vec))
        for names, es in groups.items():
            procs = np.asarray([p for p, _ in es], np.intp)
            store.set_entries(
                procs, vid,
                np.asarray([v.time for _, v in es]),
                time_var=np.asarray([v.time_var for _, v in es]),
                samples=np.asarray([v.samples for _, v in es]),
                counters={nm: np.asarray([v.counters[nm] for _, v in es])
                          for nm in names})


def build_ppg(psg: PSG, n_procs: int, perf: Optional[PerfInput] = None,
              *, replicate: bool = True, meta: Optional[dict] = None,
              sharded: bool = False) -> PPG:
    """Assemble a PPG.

    ``perf`` is a ready :class:`PerfStore` or
    :class:`~repro_torch.core.shard.ShardedStore` (the simulator fast paths —
    a sharded store is kept AS the PPG's perf store, so detection reads
    stacked shard views), or an iterable of per-host shards
    (:class:`~repro_torch.core.shard.PerfShard` blocks, consumed one at a time
    through ``PerfStore.assemble_streamed`` — the streamed multi-host
    channel), or {vid: PerfVector} (replicated to all processes — the
    single-controller measured channel), or {proc: {vid: PerfVector}} for
    per-process data.  Either way counters land in the store's
    column-sparse layout (one column block per counter, only at the
    vertices that carry it).

    ``sharded=True`` keeps an iterable of per-host shards AS the blocks
    of a :class:`~repro_torch.core.shard.ShardedStore` (their ranges must tile
    ``[0, n_procs)``) instead of merging them — the device-resident
    detection path: e.g. per-host ``GraphProfiler.perf_shard`` blocks
    feed the torch detectors through ``ppg.device_view()`` without a
    controller-side merge.  An empty shard iterable (no hosts reported
    yet) with ``sharded=False`` assembles an empty ``n_procs``-row store.
    """
    store: Optional[PerfStore] = None
    if isinstance(perf, (PerfStore, ShardedStore)):
        if sharded and not isinstance(perf, ShardedStore):
            raise ValueError("sharded=True needs an iterable of per-host "
                             "shards (or a ready ShardedStore), got a "
                             "merged PerfStore")
        if isinstance(perf, ShardedStore) and perf.n_procs != n_procs:
            # a mismatched sharded store would route out-of-range procs
            # into the last shard's local rows — fail here, like the
            # shard-iterable path does
            raise ValueError(f"ShardedStore tiles [0, {perf.n_procs}) "
                             f"but n_procs is {n_procs}")
        store = perf
    elif perf is not None and not isinstance(perf, ABCMapping):
        if sharded:
            # adopt the blocks as a ShardedStore — no merge, detection
            # feeds from per-host (device-residable) blocks
            store = ShardedStore.of(perf)
            if store.n_procs != n_procs:
                raise ValueError(f"shards tile [0, {store.n_procs}) but "
                                 f"n_procs is {n_procs}")
        else:
            # iterable of per-host shards: streamed block-concat merge
            store = PerfStore.assemble_streamed(
                perf, n_procs=n_procs, n_vertices=len(psg.vertices))
    elif sharded:
        raise ValueError("sharded=True needs an iterable of per-host "
                         "shards, not mapping/None perf data")
    ppg = PPG(psg=psg, n_procs=n_procs, perf=store, meta=dict(meta or {}))
    if perf and store is None:
        first = next(iter(perf.values()))
        if isinstance(first, PerfVector):        # {vid: vec}
            if replicate:
                # one column write per vertex instead of P x V set_perf calls
                for vid, vec in perf.items():
                    ppg.perf.set_column(
                        vid, vec.time, time_var=vec.time_var,
                        samples=vec.samples, counters=vec.counters)
            else:
                for vid, vec in perf.items():
                    ppg.set_perf(0, vid, vec)
        else:                                    # {proc: {vid: vec}}
            _store_by_proc(ppg.perf, perf)
    add_comm_edges(ppg)
    return ppg

"""Communication dependence: HLO annotation + graph-guided compression.

Two ScalAna mechanisms live here:

* ``annotate_from_hlo`` — refine a PSG with Comm vertices discovered in the
  compiled HLO (GSPMD-inserted collectives that are invisible in the jaxpr),
  attached to the best-matching control vertex by op-name scope.

* ``CommLog`` — the paper's *graph-guided communication compression* +
  *sampling-based instrumentation* (§III-B2): communication parameters are
  recorded once per (vertex, signature) with a repeat count, and record
  emission is Bernoulli-sampled.  ``full_trace_bytes`` reports what an
  uncompressed tracer would have written, for the storage benchmarks.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import (BRANCH, CALL, COMM, LOOP, PSG, PPG,
                                    vertex_pairs_array)
from repro_torch.core.hlo import CollectiveOp, parse_collectives, scope_tokens

_EVENT_BYTES = 64      # what one uncompressed trace event would cost on disk


def _find_scope_vertex(psg: PSG, op: CollectiveOp) -> int:
    """Best PSG attach point for an HLO collective: deepest control vertex
    whose name appears in the op scope path (e.g. 'while' loops)."""
    tokens = scope_tokens(op.op_name)
    best = psg.root
    best_depth, best_vid = -1, -1
    for kind in (LOOP, BRANCH, CALL):     # kind index: skips Comp/Comm bulk
        for v in psg.by_kind(kind):
            base = v.name.split(":")[0]
            if base not in tokens:
                continue
            # deepest wins; depth ties go to the lowest vid (program order)
            if v.depth > best_depth or (v.depth == best_depth
                                        and v.vid < best_vid):
                best, best_depth, best_vid = v.vid, v.depth, v.vid
    return best


def annotate_from_hlo(psg: PSG, hlo_text: str) -> List[int]:
    """Add Comm vertices for GSPMD collectives. Returns new vertex ids."""
    new_vids: List[int] = []
    for op in parse_collectives(hlo_text):
        parent = _find_scope_vertex(psg, op)
        v = psg.new_vertex(COMM, op.kind, source=op.source or op.op_name,
                           parent=parent,
                           depth=psg.vertices[parent].depth + 1)
        v.comm_kind = op.kind
        v.comm_bytes = float(op.bytes)
        v.p2p_pairs = list(op.p2p_pairs)
        v.meta["replica_groups"] = op.replica_groups
        v.meta["from_hlo"] = True
        # data edge from the previous comm/comp vertex under same parent
        sibs = [c for c in psg.children(parent) if c != v.vid]
        if sibs:
            psg.add_edge(sibs[-1], v.vid, "data")
        psg.add_edge(parent, v.vid, "control")
        new_vids.append(v.vid)
    return new_vids


# ---------------------------------------------------------------------------
# Graph-guided communication compression
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommRecord:
    vertex: int
    kind: str
    nbytes: int
    group: Tuple[int, ...]          # participant ids (or group signature)
    count: int = 0                  # repeats folded into this record


class CommLog:
    """Compressed communication-dependence log (one record per signature)."""

    def __init__(self, sample_prob: float = 1.0, seed: int = 0):
        self.records: Dict[Tuple, CommRecord] = {}
        self.events_seen = 0        # what a full tracer would have recorded
        self.sample_prob = sample_prob
        self._rng = random.Random(seed)

    def record(self, vertex: int, kind: str, nbytes: int,
               group: Sequence[int]) -> None:
        self.events_seen += 1
        key = (vertex, kind, int(nbytes), tuple(group))
        if key in self.records:
            self.records[key].count += 1
            return
        # unseen signature: sampling may skip it, but the paper's random
        # sampling keeps recording occasionally to catch changing patterns
        if self.sample_prob < 1.0 and self._rng.random() > self.sample_prob:
            return
        self.records[key] = CommRecord(vertex, kind, int(nbytes),
                                       tuple(group), count=1)

    def nbytes(self) -> int:
        """Storage actually retained (compressed)."""
        return sum(24 + 8 * len(r.group) for r in self.records.values())

    def full_trace_bytes(self) -> int:
        """Storage a full tracing tool would have written."""
        return self.events_seen * _EVENT_BYTES

    def compression_ratio(self) -> float:
        return self.full_trace_bytes() / max(self.nbytes(), 1)


# ---------------------------------------------------------------------------
# PPG comm-edge construction
# ---------------------------------------------------------------------------

def add_comm_edges(ppg: PPG, psg: Optional[PSG] = None) -> None:
    """Register inter-process dependence for every Comm vertex in the PSG.

    Collectives record their participant group (O(|group|) storage, clique
    edges resolved lazily by ``PPG.comm_partners``); p2p pairs become
    explicit edges."""
    psg = psg or ppg.psg
    for v in psg.by_kind(COMM):
        if v.p2p_pairs:
            # bulk registration: one array append per vertex (folded into
            # the explicit edge indexes lazily on first partner query)
            arr = vertex_pairs_array(v)
            keep = (arr[:, 0] < ppg.n_procs) & (arr[:, 1] < ppg.n_procs)
            ppg.comm.add_p2p_batch(v.vid, arr[keep, 0], arr[keep, 1])
            continue
        groups = v.meta.get("replica_groups")
        if groups:
            for g in groups:
                ppg.add_collective_edges(v.vid,
                                         [p for p in g if p < ppg.n_procs])
        else:
            ppg.add_collective_edges(v.vid)

"""Cross-run PSG alignment by stable structural signatures.

Two runs of the same job rarely have identical graphs: a refactor
renames a vertex, a new fusion adds a subtree, the tracer visits loops
in a different order.  Diffing per-vertex data across runs therefore
needs an explicit vertex correspondence — and it must NOT be positional
(vid i in run A is not vid i in run B once anything drifted).

A vertex's signature is ``(structural key, occurrence rank)``:

* the **structural key** is the (kind, name) path from the root to the
  vertex along parent links — the program's nesting structure, which
  survives vid renumbering and insertion-order permutation outright;
* the **occurrence rank** disambiguates true duplicates (two identical
  ``Comp matmul`` children of the same loop): the i-th occurrence in
  program (insertion) order on one side matches the i-th on the other.

A renamed vertex changes its key, so it lands in the explicit
``a_only``/``b_only`` sets instead of silently matching something else;
the same applies to added/removed subtrees.  Alignment is a property of
the PSGs alone — runs recorded at different process counts align
exactly the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.graph import PSG

Signature = Tuple[Tuple[Tuple[str, str], ...], int]


def vertex_signatures(psg: PSG) -> List[Signature]:
    """Per-vid stable signatures: ((kind, name) root path, occurrence).

    O(V) via memoized parent-chain walk; robust to permuted insertion
    order because the key depends only on the parent chain, and
    occurrence ranks are assigned in vid order (program order).
    """
    memo: Dict[int, Tuple[Tuple[str, str], ...]] = {}

    def key_of(vid: int) -> Tuple[Tuple[str, str], ...]:
        k = memo.get(vid)
        if k is None:
            v = psg.vertices[vid]
            above = key_of(v.parent) if v.parent >= 0 else ()
            k = memo[vid] = above + ((v.kind, v.name),)
        return k

    seen: Dict[Tuple, int] = {}
    sigs: List[Signature] = []
    for v in psg.vertices:
        k = key_of(v.vid)
        rank = seen.get(k, 0)
        seen[k] = rank + 1
        sigs.append((k, rank))
    return sigs


@dataclasses.dataclass
class Alignment:
    """Vertex correspondence between two PSGs.

    ``pairs`` lists matched ``(a_vid, b_vid)``; ``a_to_b`` is the (V_a,)
    lookup with -1 where unmatched.  ``a_only``/``b_only`` are the
    explicit removed/added vertex sets — nothing matches silently.
    """
    pairs: List[Tuple[int, int]]
    a_to_b: np.ndarray
    a_only: List[int]
    b_only: List[int]

    @property
    def n_matched(self) -> int:
        return len(self.pairs)

    def __repr__(self) -> str:
        return (f"Alignment({self.n_matched} matched, "
                f"{len(self.a_only)} removed, {len(self.b_only)} added)")


def align_psgs(a: PSG, b: PSG) -> Alignment:
    """Match vertices of ``a`` and ``b`` by structural signature.

    Signatures are unique per graph by construction (occurrence ranks),
    so the match is a plain dict join: same signature -> matched pair,
    anything else -> ``a_only`` (in ``a``, gone from ``b``) or
    ``b_only`` (new in ``b``)."""
    sig_a = vertex_signatures(a)
    sig_b = vertex_signatures(b)
    index_b = {sig: vid for vid, sig in enumerate(sig_b)}
    pairs: List[Tuple[int, int]] = []
    a_only: List[int] = []
    a_to_b = np.full(len(sig_a), -1, np.int64)
    matched_b = set()
    for vid, sig in enumerate(sig_a):
        bv = index_b.get(sig)
        if bv is None:
            a_only.append(vid)
        else:
            pairs.append((vid, bv))
            a_to_b[vid] = bv
            matched_b.add(bv)
    b_only = [vid for vid in range(len(sig_b)) if vid not in matched_b]
    return Alignment(pairs=pairs, a_to_b=a_to_b, a_only=a_only,
                     b_only=b_only)

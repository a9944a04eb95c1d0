"""Compiled-HLO introspection: collective ops, bytes, replica groups.

This is ScalAna's PMPI-interception analogue: in SPMD JAX the collectives
are inserted by GSPMD partitioning, so the *compiled* HLO is the ground
truth for communication structure.  We parse the per-device HLO module text
for collective ops, their payload bytes, replica groups and op-name scopes,
and (a) attach them to the PSG as Comm vertices, (b) feed the roofline's
collective term, (c) drive PPG inter-process edges.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "all-reduce-start", "all-gather-start",
    "collective-permute-start",
)

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"(" + "|".join(COLLECTIVE_OPS) + r")\(",
)
_GROUPS_LITERAL_RE = re.compile(r"replica_groups=\{\{([^}]*(?:\},\{[^}]*)*)\}\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_SOURCE_RE = re.compile(r'source_file="([^"]*)"\s+source_line=(\d+)')
_PERM_RE = re.compile(r"source_target_pairs=\{([0-9,{} ]*)\}")


def shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string; tuples summed."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _parse_groups(line: str) -> Optional[List[List[int]]]:
    m = _GROUPS_LITERAL_RE.search(line)
    if m:
        return [[int(x) for x in grp.split(",") if x.strip()]
                for grp in m.group(1).split("},{")]
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        g0, g1 = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        perm = ([int(x) for x in m.group(4).split(",")]
                if m.group(4) else list(range(len(dims))))
        arr = np.arange(int(np.prod(dims))).reshape(dims).transpose(perm)
        return arr.reshape(g0, g1).tolist()
    return None


@dataclasses.dataclass
class CollectiveOp:
    kind: str                       # all-reduce / all-gather / ...
    bytes: int                      # per-device payload (result tuple bytes)
    replica_groups: Optional[List[List[int]]]
    op_name: str                    # scope path, e.g. jit(step)/while/body/...
    source: str = ""                # file:line when present
    p2p_pairs: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    @property
    def group_size(self) -> int:
        if self.replica_groups:
            return max(len(g) for g in self.replica_groups)
        return 0


def parse_collectives(hlo_text: str) -> List[CollectiveOp]:
    """All collective ops in an HLO module text, in program order."""
    out: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if not m:
            continue
        type_str, kind = m.group(1), m.group(2)
        kind = kind.replace("-start", "")
        nbytes = shape_bytes(type_str)
        groups = _parse_groups(line)
        op_name = (_OPNAME_RE.search(line) or [None, ""])[1] \
            if _OPNAME_RE.search(line) else ""
        sm = _SOURCE_RE.search(line)
        source = f"{sm.group(1)}:{sm.group(2)}" if sm else ""
        pairs: List[Tuple[int, int]] = []
        pm = _PERM_RE.search(line)
        if pm:
            nums = [int(x) for x in re.findall(r"\d+", pm.group(1))]
            pairs = list(zip(nums[::2], nums[1::2]))
        out.append(CollectiveOp(kind, nbytes, groups, op_name, source, pairs))
    return out


def collective_bytes_total(hlo_text: str) -> Dict[str, float]:
    """Per-kind and total collective payload bytes (per device)."""
    totals: Dict[str, float] = {}
    for op in parse_collectives(hlo_text):
        totals[op.kind] = totals.get(op.kind, 0.0) + op.bytes
        totals["total"] = totals.get("total", 0.0) + op.bytes
    return totals


def collective_bytes_by_kind_and_size(hlo_text: str) -> Dict[str, Dict]:
    """Rich per-kind summary: op count, payload bytes, max group size.

    NOTE: ops inside ``while`` loop bodies appear once in the text; the
    roofline multiplies loop-body collectives by the trip count separately
    (see bench_roofline) — here we report static per-execution-of-body
    sums plus a 'in_loop' marker via computation scope when derivable.
    """
    out: Dict[str, Dict] = {}
    total = 0.0
    for op in parse_collectives(hlo_text):
        d = out.setdefault(op.kind, {"count": 0, "bytes": 0.0,
                                     "max_group": 0})
        d["count"] += 1
        d["bytes"] += op.bytes
        d["max_group"] = max(d["max_group"], op.group_size)
        total += op.bytes
    out["total_bytes"] = total
    return out


def scope_tokens(op_name: str) -> List[str]:
    """op_name scope split into structural tokens ('while', 'body', ...)."""
    return [t for t in re.split(r"[/()]", op_name) if t]

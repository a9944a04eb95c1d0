"""PSG contraction (paper §III-A "PSG Contraction").

Rules, following the paper:
  * preserve ALL Comm vertices and the control structures containing them;
  * merge runs of consecutive Comp vertices under the same parent into one
    larger Comp vertex (summing static counters);
  * prune Loop/Branch subtrees nested deeper than ``MaxLoopDepth`` unless
    they contain communication (their counters roll up into the parent);
  * drop zero-weight Comp vertices produced by layout/bookkeeping ops.

Returns the contracted PSG and an old->new vid mapping so runtime profiling
data collected at either granularity can be attributed consistently.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.graph import (BRANCH, CALL, COMM, COMP, LOOP, ROOT, PSG,
                                    Vertex)


def _contains_comm(psg: PSG, vid: int, cache: Dict[int, bool]) -> bool:
    if vid in cache:
        return cache[vid]
    v = psg.vertices[vid]
    result = v.kind == COMM or any(
        _contains_comm(psg, c, cache) for c in psg.children(vid))
    cache[vid] = result
    return result


def contract(psg: PSG, max_loop_depth: int = 10,
             min_comp_flops: float = 0.0) -> Tuple[PSG, Dict[int, int]]:
    out = PSG()
    root = out.new_vertex(ROOT, "root")
    out.root = root.vid
    mapping: Dict[int, int] = {psg.root: root.vid}
    comm_cache: Dict[int, bool] = {}

    def walk(old_parent: int, new_parent: int, depth: int) -> None:
        pending: Optional[Vertex] = None     # open merged Comp vertex

        def flush():
            nonlocal pending
            pending = None

        for cid in psg.children(old_parent):
            v = psg.vertices[cid]
            if v.kind == COMP:
                if pending is None:
                    nv = out.new_vertex(COMP, "comp", source=v.source,
                                        parent=new_parent, depth=depth)
                    pending = nv
                pending.prims.extend(v.prims)
                pending.flops += v.flops
                pending.bytes += v.bytes
                if not pending.source:
                    pending.source = v.source
                mapping[cid] = pending.vid
                continue
            flush()
            has_comm = _contains_comm(psg, cid, comm_cache)
            if v.kind in (LOOP, BRANCH, CALL):
                if depth >= max_loop_depth and not has_comm:
                    # prune subtree: fold into a single Comp summary vertex
                    nv = out.new_vertex(COMP, f"{v.name}(pruned)",
                                        source=v.source, parent=new_parent,
                                        depth=depth)
                    nv.flops, nv.bytes = v.flops, v.bytes
                    _map_subtree(psg, cid, nv.vid, mapping)
                    continue
                if v.kind == CALL and not has_comm:
                    # inline transparent calls: lift children one level up
                    mapping[cid] = new_parent
                    walk(cid, new_parent, depth)
                    continue
                nv = out.new_vertex(v.kind, v.name, source=v.source,
                                    parent=new_parent, depth=depth)
                nv.flops, nv.bytes = v.flops, v.bytes
                nv.comm_bytes = v.comm_bytes
                nv.meta = dict(v.meta)
                mapping[cid] = nv.vid
                walk(cid, nv.vid, depth + 1)
            else:  # COMM — always preserved verbatim
                nv = out.new_vertex(COMM, v.name, source=v.source,
                                    parent=new_parent, depth=depth)
                nv.comm_kind, nv.comm_bytes = v.comm_kind, v.comm_bytes
                nv.p2p_pairs = list(v.p2p_pairs)
                nv.meta = dict(v.meta)      # replica_groups
                mapping[cid] = nv.vid
        flush()

    walk(psg.root, root.vid, 0)

    # drop trivial zero-cost Comp leaves (bookkeeping ops)
    if min_comp_flops > 0.0:
        keep = {v.vid for v in out.vertices
                if not (v.kind == COMP and v.flops <= min_comp_flops
                        and v.comm_bytes == 0 and not out.children(v.vid))}
        out, submap = _filter(out, keep)
        mapping = {old: submap[n] for old, n in mapping.items() if n in submap}

    _rebuild_edges(psg, out, mapping)
    return out, mapping


def _map_subtree(psg: PSG, vid: int, target: int,
                 mapping: Dict[int, int]) -> None:
    mapping[vid] = target
    for c in psg.children(vid):
        _map_subtree(psg, c, target, mapping)


def _filter(psg: PSG, keep: Set[int]) -> Tuple[PSG, Dict[int, int]]:
    out = PSG()
    submap: Dict[int, int] = {}
    for v in psg.vertices:
        if v.vid not in keep:
            continue
        nv = out.new_vertex(v.kind, v.name, source=v.source,
                            parent=-1, depth=v.depth)
        # copy container fields: sharing them would alias the source PSG,
        # so mutating the filtered graph corrupts the original
        nv.prims, nv.flops, nv.bytes = list(v.prims), v.flops, v.bytes
        nv.comm_kind, nv.comm_bytes = v.comm_kind, v.comm_bytes
        nv.p2p_pairs, nv.meta = list(v.p2p_pairs), dict(v.meta)
        submap[v.vid] = nv.vid
    for v in psg.vertices:
        if v.vid in submap and v.parent in submap:
            out.set_parent(submap[v.vid], submap[v.parent])
    out.root = submap[psg.root]
    return out, submap


def _rebuild_edges(orig: PSG, out: PSG, mapping: Dict[int, int]) -> None:
    for (s, d, k) in orig.edges:
        ns, nd = mapping.get(s), mapping.get(d)
        if ns is None or nd is None or ns == nd:
            continue
        out.add_edge(ns, nd, k)

"""Carry state made by the JAX package over into the port's objects.

The two packages share no code, so state crosses as data: a PSG as the
JSON text of ``PSG.to_json``, a perf store as the ``(tree, meta)`` pair
of numpy leaves and JSON-able metadata that ``PerfStore.to_tree`` /
``ShardedStore.to_tree`` produce, and optionally the comm index as the
``(tree, meta)`` of ``CommIndex.to_tree``.  Built from JSON and numpy
only — nothing of the JAX package is imported — so the tests can feed
identical PPGs to both packages.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

from repro_torch.core.graph import PPG, PSG, CommIndex, PerfStore
from repro_torch.core.shard import ShardedStore

Tree = Tuple[Mapping[str, Any], Mapping[str, Any]]


def from_reference(psg_json: str, perf_tree: Tree,
                   comm_tree: Optional[Tree] = None) -> PPG:
    """A port :class:`~repro_torch.core.graph.PPG` equal to the JAX
    package's PPG whose ``psg.to_json()``, ``perf.to_tree()`` and
    (optionally) ``comm.to_tree()`` are given.  The perf store keeps its
    kind: a sharded tree rebuilds a
    :class:`~repro_torch.core.shard.ShardedStore` with the same blocks."""
    psg = PSG.from_json(psg_json)
    tree, meta = perf_tree
    if meta.get("format") == "shardedstore":
        perf = ShardedStore.from_tree(tree, meta)
    else:
        perf = PerfStore.from_tree(tree, meta)
    ppg = PPG(psg, perf.n_procs, perf)
    if comm_tree is not None:
        ppg.comm = CommIndex.from_tree(*comm_tree)
    return ppg

"""Carry state made by the JAX package over into the port's objects.

The two packages share no code, so state crosses as data: a PSG as the
JSON text of ``PSG.to_json``, a perf store as the ``(tree, meta)`` pair
of numpy leaves and JSON-able metadata that ``PerfStore.to_tree`` /
``ShardedStore.to_tree`` produce, and optionally the comm index as the
``(tree, meta)`` of ``CommIndex.to_tree``; model parameters as the
nested dict of numpy arrays of the JAX parameter pytree.  Built from
JSON and numpy only — nothing of the JAX package is imported — so the
tests can feed identical PPGs and weights to both packages.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

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


def params_from_reference(tree: Mapping[str, Any],
                          device: Optional[torch.device | str] = None
                          ) -> Dict[str, Any]:
    """The port's model parameters equal to the JAX package's parameter
    pytree ``tree`` (nested dicts whose leaves are numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``), on ``device`` (``cuda`` when
    None).

    The port keeps the reference's layouts, so each leaf is copied as it
    is: matrices stay ``(in, out)`` and are applied as ``x @ w`` (they are
    not transposed for ``nn.Linear``), and every per-layer leaf keeps its
    leading stacked ``n_layers`` axis, which the port's layer loop
    indexes."""
    dev = torch.device("cuda" if device is None else device)
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_from_reference(v, dev)
        else:
            out[k] = torch.from_numpy(np.array(v, copy=True)).to(dev)
    return out

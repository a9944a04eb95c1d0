"""Declarative parameter specs.

Each model declares its parameters once as a (possibly nested) dict of
``P(shape, logical_axes, init)``; from that single source initialization
and parameter counts are derived, consistent with each other.  The
logical axis names give the launch layer its partition specs
(:func:`param_specs_tree`) and the fan-in rule below its dims.

Per-layer leaves keep the JAX package's stacked layout: one tensor with
a leading ``n_layers`` axis per leaf; the layer loop takes views of it.

Under a ``model`` axis of the active rules a rank holds each leaf's
local shard (:func:`repro_torch.distributed.axes.local_shard`), and
under ``gather_weights`` its slice on ``data`` too: fresh weights are
drawn whole from the generator's stream and sliced, so a rank's shard is
bit-equal to that slice of the one-process tensor.  A model gathers the
``data`` slices at use (:func:`gather_at_use`): one layer's leaves at the
entry of its loop body, the others at the entry of the model function
(ZeRO-3: the whole weights of one layer live at a time, and a
checkpointed layer's recompute gathers them again).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.axes import (local_shape, local_shard, option,
                                          spec_for, weight_constraint)


@dataclasses.dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]        # logical axis names, len == ndim
    init: str = "normal"                   # normal | zeros | ones | embed
    scale: Optional[float] = None          # overrides fan-in scaling

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Specs = Dict[str, Any]   # nested dict: str -> P | Specs


def _fan_in(spec: P) -> int:
    # convention: last dim is the output dim; everything else is fan-in,
    # except stacked-layer / expert axes which don't contract in the matmul.
    dims = [d for d, a in zip(spec.shape, spec.axes) if a not in ("layers", "experts")]
    if len(dims) <= 1:
        return max(dims[0] if dims else 1, 1)
    return max(int(np.prod(dims[:-1])), 1)


def _init_leaf(gen: torch.Generator, spec: P, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(local_shape(spec.axes, spec.shape), dtype=dtype,
                           device=device)
    if spec.init == "ones":
        return torch.ones(local_shape(spec.axes, spec.shape), dtype=dtype,
                          device=device)
    if spec.init == "embed":
        scale = spec.scale if spec.scale is not None else 0.02
    else:
        scale = spec.scale if spec.scale is not None else \
            1.0 / math.sqrt(_fan_in(spec))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return local_shard(x.mul_(scale).to(dtype), spec.axes)


def _walk(specs: Specs, path=()) -> Iterator[Tuple[Tuple[str, ...], P]]:
    for k, v in sorted(specs.items()):
        if isinstance(v, P):
            yield path + (k,), v
        else:
            yield from _walk(v, path + (k,))


def init_params(specs: Specs, generator: torch.Generator,
                dtype: torch.dtype) -> Dict[str, Any]:
    """Fresh parameters on the generator's device, leaf by leaf in sorted
    path order: zeros for norms, ``0.02 * N(0, 1)`` for embeddings,
    ``N(0, 1) / sqrt(fan_in)`` for the rest; this rank's shards under the
    active rules.  The distributions are the
    JAX package's; the values are not (the generators differ), so parity
    tests carry the JAX parameters over with
    :func:`repro_torch.convert.params_from_reference`."""
    return _map_specs(specs, lambda spec: _init_leaf(generator, spec, dtype,
                                                     generator.device))


def abstract_params(specs: Specs, dtype: torch.dtype) -> Dict[str, Any]:
    """The parameters' shapes and dtype as tensors on the ``meta`` device
    (no storage): this rank's shards under the active rules."""
    return _map_specs(specs, lambda spec: torch.empty(
        local_shape(spec.axes, spec.shape), dtype=dtype, device="meta"))


def local_params(params: Dict[str, Any], specs: Specs) -> Dict[str, Any]:
    """This rank's shards of whole ``params`` under the active rules."""
    flat = dict(_walk(specs))

    def go(tree, path):
        return {k: go(v, path + (k,)) if isinstance(v, dict)
                else local_shard(v, flat[path + (k,)].axes)
                for k, v in tree.items()}
    return go(params, ())


def gather_at_use(tree: Dict[str, Any], make_specs: Callable[[Any], Specs],
                  cfg: Any, skip: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``tree`` with each leaf that ``gather_weights`` stores split on
    ``data`` gathered whole there (:func:`~repro_torch.distributed.axes.
    weight_constraint`: an all-gather forward, a reduce-scatter of its
    gradient backward), the other leaves as they are.  ``make_specs(cfg)``
    is the congruent spec tree, built once a config and only under the
    option; the subtrees under the keys in ``skip`` (the stacked layers,
    gathered a layer at a time) pass through."""
    if not option("gather_weights"):
        return tree
    return _gather(tree, _spec_tree(make_specs, cfg), skip)


@functools.lru_cache(maxsize=None)
def _spec_tree(make_specs: Callable[[Any], Specs], cfg: Any) -> Specs:
    return make_specs(cfg)


def _gather(tree: Dict[str, Any], specs: Specs,
            skip: Tuple[str, ...] = ()) -> Dict[str, Any]:
    return {k: v if k in skip
            else _gather(v, specs[k]) if isinstance(v, dict)
            else weight_constraint(v, *specs[k].axes, shape=specs[k].shape)
            for k, v in tree.items()}


def param_specs_tree(specs: Specs) -> Dict[str, Any]:
    """PartitionSpec tree (resolved against the active mesh/rules)."""
    return _map_specs(specs, lambda spec: spec_for(spec.axes, spec.shape))


def _map_specs(specs: Specs, fn) -> Dict[str, Any]:
    """``fn(spec)`` for each leaf spec, in sorted path order, as a tree."""
    out: Dict[str, Any] = {}
    for path, spec in _walk(specs):
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = fn(spec)
    return out


def param_count(specs: Specs) -> int:
    return sum(int(np.prod(s.shape)) for _, s in _walk(specs))

"""Declarative parameter specs.

Each model declares its parameters once as a (possibly nested) dict of
``P(shape, logical_axes, init)``; from that single source initialization
and parameter counts are derived, consistent with each other.  The
logical axis names give the launch layer its partition specs
(:func:`param_specs_tree`) and the fan-in rule below its dims.

Per-layer leaves keep the JAX package's stacked layout: one tensor with
a leading ``n_layers`` axis per leaf; the layer loop takes views of it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.axes import spec_for


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
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        scale = spec.scale if spec.scale is not None else 0.02
    else:
        scale = spec.scale if spec.scale is not None else \
            1.0 / math.sqrt(_fan_in(spec))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


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
    ``N(0, 1) / sqrt(fan_in)`` for the rest.  The distributions are the
    JAX package's; the values are not (the generators differ), so parity
    tests carry the JAX parameters over with
    :func:`repro_torch.convert.params_from_reference`."""
    return _map_specs(specs, lambda spec: _init_leaf(generator, spec, dtype,
                                                     generator.device))


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

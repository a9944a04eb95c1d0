"""The cell's weights, made on the device from the seed in the type they
are trained in: one draw from a ``torch.Generator`` on the card for all
the random leaves together, cut into the leaves the program's parameter
specs declare (names, shapes, init kind), then scaled.  The same seed
gives the same weights, bit for bit, on the same device, so the judge
makes them again instead of keeping a copy."""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch


def _walk(specs: Dict, path: Tuple[str, ...] = ()) -> Iterator:
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _scale(spec) -> float:
    """0.02 for embeddings; else the spec's own scale, or 1/sqrt(fan-in)
    with every dim but the last (and but stacked layers) as fan-in."""
    if spec.init == "embed":
        return spec.scale if spec.scale is not None else 0.02
    if spec.scale is not None:
        return spec.scale
    dims = [n for n, a in zip(spec.shape, spec.axes) if a != "layers"]
    return 1.0 / math.sqrt(max(math.prod(dims[:-1]) if len(dims) > 1
                               else dims[0], 1))


def make(specs: Dict, seed: int, device, dtype=torch.float32) -> Dict:
    """A nested dict of leaves congruent with ``specs``."""
    leaves = list(_walk(specs))
    random = [(p, s) for p, s in leaves if s.init in ("normal", "embed")]
    total = sum(math.prod(s.shape) for _, s in random)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    pool = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out: Dict = {}
    at = 0
    for path, spec in leaves:
        n = math.prod(spec.shape)
        if spec.init in ("normal", "embed"):
            leaf = pool[at:at + n].view(spec.shape).mul_(_scale(spec))
            at += n
        elif spec.init == "zeros":
            leaf = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            leaf = torch.ones(spec.shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"init {spec.init!r} of {'/'.join(path)}")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return out

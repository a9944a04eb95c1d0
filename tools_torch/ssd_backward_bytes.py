"""Bytes written by each ATen op of the SSD core's forward and backward.

Traces :func:`repro_torch.models.mamba2.ssd_chunked` and the gradients of
its output with respect to its five inputs (y's cotangent alone, as a
train step takes them) with ``make_fx(tracing_mode="fake")``: fake
tensors, so a benchmark cell's full shape costs no memory and runs on
the CPU.  A node's bytes are the sizes of the tensors it outputs; views
(and ``_unsafe_view``, a reshape that copies nothing) write nothing and
count none, in-place ops count what they overwrite.
Sizes an SSD change before it goes to the card; part of no cell:

    python3 tools_torch/ssd_backward_bytes.py
    python3 tools_torch/ssd_backward_bytes.py --shape 2,1000,4,8,16,64
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import Counter
from typing import Callable, Dict, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402

# (batch, seq, heads, head dim, state, chunk) of each benchmark cell's
# SSD layer (chipbench/configs, chipbench/traffic)
CELLS = {
    "mamba2-130m.train": (8, 4096, 24, 64, 128, 64),
    "zamba2-2.7b.train": (1, 4096, 80, 64, 64, 64),
}


def trace(shape: Tuple[int, ...], ssd: Callable = ssd_chunked
          ) -> torch.fx.GraphModule:
    """The forward and backward of ``ssd`` (``ssd_chunked``'s signature)
    at ``shape`` = (B, S, H, P, N, Q), on fake tensors."""
    B, S, H, Pd, N, Q = shape

    def step(x, dt, A, Bm, Cm, gy):
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y = ssd(*ins, Q)
        return (y, *torch.autograd.grad(y, ins, gy))

    args = (torch.empty(B, S, H, Pd), torch.empty(B, S, H), torch.empty(H),
            torch.empty(B, S, N), torch.empty(B, S, N),
            torch.empty(B, S, H, Pd))
    with torch.enable_grad():
        return make_fx(step, tracing_mode="fake")(*args)


def _outputs(val):
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return []


def written(gm: torch.fx.GraphModule) -> Dict[str, Tuple[int, int, int]]:
    """Per ATen op: (nodes, bytes written, the largest output's elements),
    view ops left out."""
    nodes, nbytes, largest = Counter(), Counter(), Counter()
    for n in gm.graph.nodes:
        op = n.target
        if n.op != "call_function" or not isinstance(
                op, torch._ops.OpOverload) or op.is_view or \
                op.overloadpacket is torch.ops.aten._unsafe_view:
            continue
        name = op.overloadpacket.__name__
        outs = _outputs(n.meta.get("val"))
        nodes[name] += 1
        nbytes[name] += sum(t.numel() * t.element_size() for t in outs)
        largest[name] = max([largest[name]] + [t.numel() for t in outs])
    return {k: (nodes[k], nbytes[k], largest[k]) for k in nodes}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="",
                    help="B,S,H,P,N,Q; default: each benchmark cell's")
    args = ap.parse_args(argv)
    shapes = ({"shape": tuple(int(v) for v in args.shape.split(","))}
              if args.shape else CELLS)
    for name, shape in shapes.items():
        B, S, H, Pd, N, Q = shape
        nc = -(-S // Q)
        st = B * nc * H * N * Pd                   # elements
        per_op = written(trace(shape))
        total = sum(b for _, b, _ in per_op.values())
        print(f"{name} {shape}: nc {nc}, st {st * 4 / 1e6:.1f} MB, "
              f"{total / 1e9:.2f} GB written by "
              f"{sum(c for c, _, _ in per_op.values())} nodes")
        print(f"  {'op':<28}{'nodes':>7}{'GB':>10}{'largest/st':>12}")
        for op, (c, b, big) in sorted(per_op.items(),
                                      key=lambda kv: -kv[1][1]):
            print(f"  {op:<28}{c:>7}{b / 1e9:>10.3f}{big / st:>12.3f}")


if __name__ == "__main__":
    main()

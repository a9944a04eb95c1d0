"""Static per-node cost model: the 'hardware counter' channel (PAPI analogue).

Estimates FLOPs and bytes accessed for one ATen node of a traced torch
program, from the shapes its fake values carry (``node.meta["val"]``),
so every PSG vertex carries static counters before any run.  The JAX
package's rules per jaxpr equation, over ATen ops: matmul-family ops are
exact; transcendental ops count 8 a result element; elementwise ops and
reductions count their size; view, layout and data-movement ops and
unknowns count no FLOPs.  Bytes are operands plus results.
"""
from __future__ import annotations

import math
from typing import Any, Iterator, Tuple

import torch

# 8 flops a result element
TRANSCENDENTAL = frozenset({
    "exp", "exp_", "exp2", "log", "log2", "log10", "tanh", "sigmoid", "erf",
    "erfc", "rsqrt", "sqrt", "sin", "cos", "cumsum", "logcumsumexp",
    "logsumexp", "_softmax", "_log_softmax", "silu", "gelu", "softplus",
    "silu_backward", "gelu_backward", "softplus_backward",
    "sigmoid_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
})
# max(operand size, result size) flops
ELEMENTWISE = frozenset({
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "maximum", "minimum", "neg", "abs", "where", "clamp", "clamp_min",
    "clamp_max", "sum", "mean", "amax", "amin", "max", "min", "square",
    "sign", "floor", "ceil", "round", "remainder", "fmod", "reciprocal",
    "log1p", "expm1", "logical_and", "logical_or", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "masked_fill", "masked_fill_", "tanh_backward", "threshold_backward",
    "relu", "embedding_dense_backward", "scatter_add", "index_add",
    "addcmul", "addcdiv", "lerp", "norm", "linalg_vector_norm",
})


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    """The tensor values under an fx argument (nodes, lists, tuples)."""
    if isinstance(x, torch.fx.Node):
        yield from _tensors(x.meta.get("val"))
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, torch.Tensor):
        yield x


def _size(t: torch.Tensor) -> int:
    return math.prod(int(d) for d in t.shape)


def op_name(node: torch.fx.Node) -> str:
    """``aten.mm.default`` -> ``mm``."""
    target = node.target
    name = getattr(target, "__name__", str(target))
    return getattr(getattr(target, "overloadpacket", None), "__name__",
                   name.split(".")[0])


def node_costs(node: torch.fx.Node) -> Tuple[float, float]:
    """Returns (flops, bytes_accessed) for one ATen node."""
    ins = list(_tensors(list(node.args) + list(node.kwargs.values())))
    outs = list(_tensors(node.meta.get("val")))
    nbytes = float(sum(_size(t) * t.element_size() for t in ins + outs))
    name = op_name(node)

    if name == "mm" or name == "addmm":
        a, b = ins[-2], ins[-1]
        return float(2 * a.shape[0] * a.shape[1] * b.shape[1]), nbytes
    if name == "bmm" or name == "baddbmm":
        a, b = ins[-2], ins[-1]
        return (float(2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]),
                nbytes)
    if name == "convolution" and outs:
        w = ins[1]
        per_out = _size(w) // max(int(w.shape[0]), 1)
        return float(2 * _size(outs[0]) * per_out), nbytes

    out_size = sum(_size(t) for t in outs)
    if name in TRANSCENDENTAL:
        return float(8 * out_size), nbytes
    if name == "pow":
        exponent = node.args[1] if len(node.args) > 1 else None
        if isinstance(exponent, (int, float)) and float(exponent).is_integer():
            return float(max(sum(_size(t) for t in ins), out_size)), nbytes
        return float(8 * out_size), nbytes
    if name in ELEMENTWISE:
        return float(max(sum(_size(t) for t in ins), out_size)), nbytes
    return 0.0, nbytes

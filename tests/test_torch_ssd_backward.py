"""The SSD core's inter-chunk state passing: values and backward cost.

``ssd_chunked`` takes the chunk views of the decays and chunk states once
(``unbind``), so its backward writes each chunk's gradient once (one
``stack``).  Indexing them once a chunk, as the form kept below does,
gives the same numbers, but each index's backward (``select_backward``)
writes a zero tensor the size of all the chunk states and autograd adds
the ``nc`` of them: bytes quadratic in the chunk count.
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from repro_torch.models.mamba2 import ssd_chunked
from tools_torch.ssd_backward_bytes import trace, written


def _ssd_indexed(x, dt, A, Bm, Cm, chunk, return_final=False):
    """``ssd_chunked`` with the chunk states indexed once a chunk."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    xc = x.reshape(Bsz, nc, Q, H, Pd)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    dA = dtc * A
    s = torch.cumsum(dA, dim=2)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    L = s[:, :, :, None, :] - s[:, :, None, :, :]
    above = torch.ones((Q, Q), dtype=torch.bool,
                       device=x.device).triu(1)[None, None, :, :, None]
    L = L.masked_fill_(above, float("-inf")).exp_()
    M = CB[..., None] * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xc)
    decay_to_end = torch.exp(s[:, :, -1:, :] - s)
    st = torch.einsum("bcqh,bcqn,bcqhp->bchnp",
                      decay_to_end * dtc, Bc, xc)
    a = torch.exp(s[:, :, -1, :])
    h = torch.zeros_like(st[:, 0])
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * a[:, c, :, None, None] + st[:, c]
    h_prev = torch.stack(entering, dim=1)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp",
                           Cc, torch.exp(s), h_prev)
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)[:, :S0]
    if return_final:
        return y, h
    return y


def _inputs(S, B=2, H=3, Pd=4, N=5, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    return (rnd(B, S, H, Pd), F.softplus(rnd(B, S, H)),
            -torch.exp(rnd(H)), rnd(B, S, N), rnd(B, S, N))


@pytest.mark.parametrize("S,chunk", [(8, 8), (48, 8), (45, 8)],
                         ids=["one_chunk", "six_chunks", "ragged"])
def test_state_passing_equals_the_indexed_form_bitwise(S, chunk):
    base = _inputs(S)
    outs = {}
    for name, ssd in (("unbind", ssd_chunked), ("indexed", _ssd_indexed)):
        ins = [t.clone().requires_grad_(True) for t in base]
        y, h = ssd(*ins, chunk, return_final=True)
        g = torch.Generator().manual_seed(1)
        gy = torch.randn(y.shape, generator=g)
        gh = torch.randn(h.shape, generator=g)
        grads = torch.autograd.grad((y, h), ins, (gy, gh))
        outs[name] = (y, h) + grads
    for new, old in zip(outs["unbind"], outs["indexed"]):
        assert torch.equal(new, old)


# (B, S, H, P, N, Q): N P > Q, so a chunk state outsizes a chunk of y;
# S ragged at 32 chunks, so the padding's slices are traced too
SMALL, LONG = (1, 64, 2, 4, 16, 8), (1, 253, 2, 4, 16, 8)


@pytest.mark.parametrize("ssd,linear", [(ssd_chunked, True),
                                        (_ssd_indexed, False)],
                         ids=["unbind", "indexed"])
def test_backward_bytes_grow_linearly_in_the_chunks(ssd, linear):
    costs = []
    for shape in (SMALL, LONG):
        B, S, H, Pd, N, Q = shape
        st = B * -(-S // Q) * H * N * Pd
        per_op = written(trace(shape, ssd))
        full = [per_op.get(op, (0, 0, 0))[2]
                for op in ("select_backward", "slice_backward")]
        costs.append((max(full) >= st,
                      sum(b for _, b, _ in per_op.values())))
    (full8, bytes8), (full32, bytes32) = costs
    # four times the chunks: under 5x the bytes where the backward
    # writes each chunk's gradient once; the indexed form's full-size
    # zeros make it quadratic
    assert (not full8 and not full32 and bytes32 / bytes8 < 5) == linear

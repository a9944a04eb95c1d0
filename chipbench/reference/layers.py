"""Plain float32 PyTorch layers of the benchmark's reference models.

Written from the published equations (Mamba2: arXiv:2405.21060 §6,
"ssd_minimal"; Zamba2: arXiv:2411.15242), independent of the program
under test.  Every matrix product is a two-operand ``einsum`` or ``@``,
so that ``torch.utils.flop_counter.FlopCounterMode`` counts exactly the
products that ``chipbench/flops/count.py`` lists.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             dims=(-1,)) -> torch.Tensor:
    """``x / rms(x) * (1 + w)`` over ``dims`` (zero-initialised weight)."""
    ms = x.square().mean(dim=dims, keepdim=True)
    return x * torch.rsqrt(ms + eps) * (1.0 + w)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along dim 1, then SiLU.
    u: (B, S, *C), w: (W, *C), b: (*C).  Output t sees inputs t-W+1..t."""
    W, S = w.shape[0], u.shape[1]
    acc = b.expand_as(u).clone()
    for lag in range(W):                  # tap W-1-lag reads input t-lag
        shifted = u if lag == 0 else F.pad(
            u[:, :S - lag], (0, 0) * (u.dim() - 2) + (lag, 0))
        acc = acc + shifted * w[W - 1 - lag]
    return F.silu(acc)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD scan by chunks.  x: (b, s, h, p); dt: (b, s, h) (positive);
    A: (h,) (negative); Bm, Cm: (b, s, n), one group shared by the heads.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = h_t^T C_t.  Within a
    chunk of ``chunk`` positions the output is a masked quadratic form
    (the "diagonal blocks"); the states at the chunk ends pass from chunk
    to chunk by a first-order recurrence (the "off-diagonal blocks")."""
    b, s0, h, p = x.shape
    n = Bm.shape[-1]
    Q = min(chunk, s0)
    pad = (-s0) % Q
    if pad:                   # zero dt and zero inputs: state-neutral steps
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    c = x.shape[1] // Q
    X = (x * dt[..., None]).reshape(b, c, Q, h, p)         # dt_t x_t
    Bc = Bm.reshape(b, c, Q, n)
    Cc = Cm.reshape(b, c, Q, n)
    acs = (dt * A).reshape(b, c, Q, h).cumsum(dim=2)       # (b, c, Q, h)

    # diagonal blocks: y_l = sum_{s<=l} exp(acs_l - acs_s) (C_l.B_s) X_s
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]    # (b,c,l,s,h)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~keep[None, None, :, :, None],
                                      -math.inf))
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    M = (decay * CB[..., None]).permute(0, 1, 4, 2, 3)     # (b,c,h,l,s)
    y_diag = torch.einsum("bchls,bcshp->bclhp", M, X)

    # the state each chunk adds at its end
    to_end = torch.exp(acs[:, :, -1:, :] - acs)            # (b, c, Q, h)
    states = torch.einsum("bcsn,bcshp->bchpn", Bc, X * to_end[..., None])

    # states entering each chunk, chunk after chunk
    across = torch.exp(acs[:, :, -1, :])                   # (b, c, h)
    run = torch.zeros_like(states[:, 0])
    entering = []
    for k in range(c):
        entering.append(run)
        run = run * across[:, k, :, None, None] + states[:, k]
    Hin = torch.stack(entering, dim=1)                     # (b,c,h,p,n)

    # off-diagonal blocks: y_l += exp(acs_l) C_l . h_entering
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, Hin) \
        * torch.exp(acs)[..., None]
    return (y_diag + y_off).reshape(b, c * Q, h, p)[:, :s0]


def ssd_block(p: dict, x: torch.Tensor, arch) -> torch.Tensor:
    """The Mamba2 block on normed input x: (B, S, D) -> (B, S, D).
    Separate projections for z, x, B, C and dt; causal depthwise
    convolutions on x, B and C; the SSD scan with a skip ``D``; the
    output gated by SiLU(z), RMS-normed over all H*P features, then
    projected back."""
    z = torch.einsum("bsd,dhp->bshp", x, p["w_z"])
    xs = torch.einsum("bsd,dhp->bshp", x, p["w_x"])
    B = torch.einsum("bsd,dn->bsn", x, p["w_B"])
    C = torch.einsum("bsd,dn->bsn", x, p["w_C"])
    dt = torch.einsum("bsd,dh->bsh", x, p["w_dt"])
    xs = causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
    B = causal_conv(B, p["conv_B_w"], p["conv_B_b"])
    C = causal_conv(C, p["conv_C_w"], p["conv_C_b"])
    dt = softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(xs, dt, A, B, C, arch.ssm_chunk) + p["D"][:, None] * xs
    y = rms_norm(y * F.silu(z), p["gate_norm"], arch.norm_eps, dims=(-2, -1))
    return torch.einsum("bshp,hpd->bsd", y, p["out_proj"])


def rotate(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding over (B, S, heads, hd), the two halves of
    each head rotated as pairs (i, i + hd/2)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, arch) -> torch.Tensor:
    """Causal multi-head self-attention with rotary positions (the
    query and key/value heads are equal in the configurations here)."""
    Bsz, S, _ = x.shape
    nh, nkv = arch.n_heads, arch.n_kv_heads
    hd = arch.head_dim or arch.d_model // nh
    q = rotate((x @ p["wq"]).reshape(Bsz, S, nh, hd), arch.rope_theta)
    k = rotate((x @ p["wk"]).reshape(Bsz, S, nkv, hd), arch.rope_theta)
    v = (x @ p["wv"]).reshape(Bsz, S, nkv, hd)
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    w = torch.softmax(scores.masked_fill(future, -math.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return o.reshape(Bsz, S, nh * hd) @ p["wo"]


def mlp(p: dict, x: torch.Tensor, arch) -> torch.Tensor:
    if arch.mlp != "gelu":
        raise NotImplementedError(f"reference MLP {arch.mlp!r}")
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def cross_entropy_sum(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      rows: int, remat: bool = True) -> torch.Tensor:
    """Sum over positions of -log softmax(h @ w)[label], ``rows`` positions
    at a time, each block recomputed in the backward (``remat``), so that
    the whole (positions, vocabulary) logit matrix never lives at once."""
    from torch.utils.checkpoint import checkpoint
    h, labels = h.reshape(-1, h.shape[-1]), labels.reshape(-1)

    def block(hb, lb):
        logits = hb @ w
        return (torch.logsumexp(logits, dim=-1)
                - logits.gather(1, lb[:, None])[:, 0]).sum()

    total = h.new_zeros(())
    for i in range(0, h.shape[0], rows):
        args = (h[i:i + rows], labels[i:i + rows])
        total = total + (checkpoint(block, *args, use_reentrant=False)
                         if remat else block(*args))
    return total

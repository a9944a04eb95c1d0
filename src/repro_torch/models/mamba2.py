"""Mamba2 / SSD (state-space duality) block — chunked scan + one-step decode.

Selective state space:  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x) x_t,
y_t = C_t . h_t + D * x_t, with per-head scalar A (Mamba2's SSD restriction).

Training and prefill use the chunked SSD algorithm (arXiv:2405.21060 §6):
an intra-chunk "attention-like" term plus an inter-chunk state recurrence.
Behind ``cfg.use_kernels`` the scan is the hand-written CUDA kernel
(:mod:`repro_torch.kernels.ssd_scan`); :func:`ssd_chunked` is the plain
version and the single source of the semantics.  Decode carries
(conv_state, ssm_state) and is O(1) per token.

The JAX package's sharding hints (``logical_constraint``,
``weight_constraint``) are identities on one card and are left out.
``softplus`` is ``logaddexp(x, 0)``, the formula of ``jax.nn.softplus``
(``F.softplus`` switches to the identity above 20).

Under a ``model`` axis (:func:`split`) a rank runs its SSD heads, or,
where the heads do not divide the axis, every head on its slice of the
head dim (``ssm_pdim``, the reference's fallback; the scan is
independent along P).  The z/x streams (and dt under the head split) are
column-parallel on ``copy_to_model(x)``; B and C come from whole weights
on ``x`` itself, and their conv outputs pass ``copy_to_model`` once
before the scan, whose rank only sees its heads' use of them.  Under the
P split dt, A and D are whole too, each summed the same way.  The gated
norm adds the ranks' sums of squares (:func:`~repro_torch.distributed.
axes.sum_over_model`) and ``out_proj`` is row-parallel.  A rank's decode
state is its own: the packed conv state ``[its x channels | B | C]`` and
the SSM state of its heads (or P slice).

Under sequence parallelism (``seq``: the block's input and output are the
rank's seq slices) the input is gathered on seq before the projections
(a reduce-scatter backward, which sums the ranks' partial cotangents of
the column-parallel streams; the whole-weight streams B, C and, under the
P split, dt count theirs once, :func:`~repro_torch.distributed.axes.
model_grad_share`), so the conv and the scan see the whole sequence of
the rank's heads, and ``out_proj``'s partial sums are reduce-scattered.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import axes as ax
from repro_torch.models.params import P


def ssd_block_specs(cfg: ArchConfig) -> Dict[str, P]:
    """Split, layout-native projections, as the JAX package declares them:
    separate per-stream weights, the x streams as 3-D (d, H, P)."""
    d, n, hh, pd = cfg.d_model, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cw = cfg.conv_width
    return {
        "w_z": P((d, hh, pd), ("embed", "ssm_heads", "ssm_pdim")),
        "w_x": P((d, hh, pd), ("embed", "ssm_heads", "ssm_pdim")),
        "w_B": P((d, n), ("embed", "state")),
        "w_C": P((d, n), ("embed", "state")),
        "w_dt": P((d, hh), ("embed", "ssm_heads")),
        "conv_x_w": P((cw, hh, pd), ("conv", "ssm_heads", "ssm_pdim"),
                      scale=0.5),
        "conv_x_b": P((hh, pd), ("ssm_heads", "ssm_pdim"), init="zeros"),
        "conv_B_w": P((cw, n), ("conv", "state"), scale=0.5),
        "conv_B_b": P((n,), ("state",), init="zeros"),
        "conv_C_w": P((cw, n), ("conv", "state"), scale=0.5),
        "conv_C_b": P((n,), ("state",), init="zeros"),
        "dt_bias": P((hh,), ("ssm_heads",), init="zeros"),
        "A_log": P((hh,), ("ssm_heads",), init="zeros"),
        "D": P((hh,), ("ssm_heads",), init="ones"),
        "gate_norm": P((hh, pd), ("ssm_heads", "ssm_pdim"), init="zeros"),
        "out_proj": P((hh, pd, d), ("ssm_heads", "ssm_pdim", "embed")),
    }


class Split(NamedTuple):
    """How the active rules split one SSD block over the ``model`` axis."""
    dim: Optional[int]   # 1: heads, 2: head dim (of w_x's (d, H, P)), None
    heads: int           # this rank's heads
    pdim: int            # and their width

    @property
    def tp(self) -> bool:
        return self.dim is not None

    @property
    def inner(self) -> int:
        return self.heads * self.pdim


def split(cfg: ArchConfig) -> Split:
    """This rank's part of the SSD block under the active rules."""
    hh, pd = cfg.ssm_heads, cfg.ssm_head_dim
    d = ax.model_dim(("embed", "ssm_heads", "ssm_pdim"),
                     (cfg.d_model, hh, pd))
    m = ax.model_size()
    if d == 1:
        return Split(1, hh // m, pd)
    if d == 2:
        return Split(2, hh, pd // m)
    return Split(None, hh, pd)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. x: (B,S,...C), w: (W,...C).

    Unrolled taps, as in the reference: ``F.conv1d`` would send a float32
    convolution to cuDNN, in TF32 by default on the card."""
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0) * (x.dim() - 2) + (W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):                      # W is tiny (4): unrolled taps
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                return_final: bool = False):
    """Chunked SSD core (the plain version of the CUDA kernel).

    x: (B,S,H,P)  dt: (B,S,H) (already softplus'ed)  A: (H,) negative
    Bm, Cm: (B,S,N) (single group, broadcast over heads)
    Returns y: (B,S,H,P) [, final state (B,H,N,P)].

    The reference's inter-chunk ``associative_scan`` is a sequential loop
    over chunks here: the same recurrence, its products associated in
    another order.  The causal mask is applied before ``exp`` (the
    reference masks after it), so the upper triangle never overflows;
    the kept entries are the same.
    """
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S0 = S
    if S % Q:                       # pad with dt=0 steps: state-neutral
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

    dA = dtc * A                                             # (B,nc,Q,H)
    s = torch.cumsum(dA, dim=2)                              # inclusive
    # intra-chunk: Y[i] = sum_{j<=i} exp(s_i - s_j) dt_j (C_i.B_j) x_j
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)              # (B,nc,Q,Q)
    L = s[:, :, :, None, :] - s[:, :, None, :, :]            # (B,nc,Q,Q,H)
    above = torch.ones((Q, Q), dtype=torch.bool,
                       device=x.device).triu(1)[None, None, :, :, None]
    L = L.masked_fill_(above, float("-inf")).exp_()          # L is ours
    M = CB[..., None] * L * dtc[:, :, None, :, :]            # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xc)

    # chunk states: St_c = sum_j exp(s_Q - s_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(s[:, :, -1:, :] - s)             # (B,nc,Q,H)
    st = torch.einsum("bcqh,bcqn,bcqhp->bchnp",
                      decay_to_end * dtc, Bc, xc)

    # inter-chunk recurrence over nc: h_c = a_c h_{c-1} + st_c
    a = torch.exp(s[:, :, -1, :])                            # (B,nc,H)
    h = torch.zeros_like(st[:, 0])
    entering = []                   # state entering chunk c = h_{c-1}
    for c in range(nc):
        entering.append(h)
        h = h * a[:, c, :, None, None] + st[:, c]
    h_prev = torch.stack(entering, dim=1)                    # (B,nc,H,N,P)

    # inter-chunk output: Y[i] += C_i . (exp(s_i) h_prev)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp",
                           Cc, torch.exp(s), h_prev)
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)[:, :S0]
    if return_final:
        return y, h                                          # (B,H,N,P)
    return y


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, conv_width-1, d_inner + 2N) rolling conv input
    h: torch.Tensor       # (B, H, N, P) ssm state


def init_ssm_state(cfg: ArchConfig, batch: int, n_layers: int,
                   dtype: torch.dtype, device) -> SSMState:
    """Zero states of this rank's part of the block (:func:`split`)."""
    sp, n = split(cfg), cfg.ssm_state
    return SSMState(
        torch.zeros((n_layers, batch, cfg.conv_width - 1, sp.inner + 2 * n),
                    dtype=dtype, device=device),
        torch.zeros((n_layers, batch, sp.heads, n, sp.pdim),
                    dtype=torch.float32, device=device),
    )


def _rms_norm_hp(y: torch.Tensor, w: torch.Tensor, eps: float,
                 width: Optional[int] = None) -> torch.Tensor:
    """RMS norm over the flattened (H, P) feature dims. y: (B,S,H,P).
    With ``width`` (the whole H·P) y is a rank's part of the features:
    the ranks' sums of squares are added over ``model``."""
    dt = y.dtype
    y32 = y.float()
    if width is None:
        ms = torch.mean(y32 * y32, dim=(-2, -1), keepdim=True)
    else:
        ms = ax.sum_over_model(torch.sum(y32 * y32, dim=(-2, -1),
                                         keepdim=True)) / width
    y32 = y32 * torch.rsqrt(ms + eps)
    return (y32 * (1.0 + w.float())).to(dt)


def _streams(p: Dict[str, torch.Tensor], x: torch.Tensor, sp: Split,
             eq: str, seq: bool = False):
    """The block's input projections of ``x`` (``eq`` the einsum of the
    3-D x streams): z, x, B, C and dt, on this rank's part (``seq``: x is
    the rank's seq slice; the streams are of the whole sequence)."""
    if seq and sp.tp:
        xc = ax.enter_parallel(x, True)           # column-parallel streams
        x = ax.model_grad_share(xc)               # whole-weight streams
    elif seq:
        xc = x = ax.whole_seq(x, True)
    else:
        xc = ax.copy_to_model(x) if sp.tp else x
    z = torch.einsum(eq, xc, p["w_z"])
    x_raw = torch.einsum(eq, xc, p["w_x"])
    dt = (xc if sp.dim == 1 else x) @ p["w_dt"]
    return z, x_raw, x @ p["w_B"], x @ p["w_C"], dt


def _scan_params(sp: Split, p: Dict[str, torch.Tensor], dt: torch.Tensor):
    """(dt, A, D) after the bias and softplus; under the P split they are
    whole on every rank, their gradients each rank's part: summed."""
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    D = p["D"]
    if sp.dim == 2:
        dt, A, D = (ax.copy_to_model(t) for t in (dt, A, D))
    return dt, A, D


def _out(cfg: ArchConfig, p: Dict[str, torch.Tensor], sp: Split,
         y: torch.Tensor, eq: str, seq: bool = False) -> torch.Tensor:
    """The gated norm's output through the row-parallel ``out_proj``
    (``seq``: reduce-scattered to the rank's seq slice)."""
    y = _rms_norm_hp(y, p["gate_norm"], cfg.norm_eps,
                     cfg.d_inner if sp.tp else None)
    out = torch.einsum(eq, y, p["out_proj"])
    return ax.leave_parallel(out, seq) if sp.tp else ax.own_seq(out, seq)


def ssd_block_train(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, return_state: bool = False,
                    seq: bool = False):
    """Full Mamba2 block, training/prefill path. x: (B,S,D) -> (B,S,D)
    (``seq``: the rank's seq slices of both).

    With ``return_state`` also returns (conv_state, ssm_state) at sequence
    end so prefill can hand off to O(1) decode.
    """
    n, sp = cfg.ssm_state, split(cfg)
    z, x_raw, B_raw, C_raw, dt = _streams(p, x, sp, "bsd,dhp->bshp", seq)
    B, S = z.shape[:2]
    xh = _causal_conv(x_raw, p["conv_x_w"], p["conv_x_b"])
    Bm = _causal_conv(B_raw, p["conv_B_w"], p["conv_B_b"])
    Cm = _causal_conv(C_raw, p["conv_C_w"], p["conv_C_b"])
    if sp.tp:               # one all-reduce of B and C in the backward
        Bm, Cm = ax.copy_to_model(torch.cat([Bm, Cm], -1)).split(n, -1)
    dt, A, D = _scan_params(sp, p, dt)
    if cfg.use_kernels:
        # imported here, as in the reference: kernels/ssd_scan/ref.py
        # imports ssd_chunked from this module
        from repro_torch.kernels.ssd_scan.ops import ssd_scan
        y, h_final = ssd_scan(xh.float(), dt, A, Bm.float(), Cm.float(),
                              chunk=cfg.ssm_chunk, return_final=True)
    else:
        y, h_final = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                                 cfg.ssm_chunk, return_final=True)
    y = y + D[None, None, :, None].float() * xh.float()
    y = y.to(x.dtype)
    out = _out(cfg, p, sp, y * F.silu(z), "bshp,hpd->bsd", seq)
    if return_state:
        W = cfg.conv_width
        # decode conv state stays packed [x | B | C] for a stable cache
        # layout
        conv_state = torch.cat(
            [x_raw[:, S - (W - 1):].reshape(B, W - 1, sp.inner),
             B_raw[:, S - (W - 1):], C_raw[:, S - (W - 1):]], dim=-1)
        return out, (conv_state, h_final)
    return out


def ssd_block_decode(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor,
                     state: Tuple[torch.Tensor, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode. x: (B,1,D); state = (conv (B,W-1,C), h (B,H,N,P)),
    this rank's (:func:`init_ssm_state`)."""
    conv_state, h = state
    B = x.shape[0]
    n, sp = cfg.ssm_state, split(cfg)
    di = sp.inner
    z, x_new, B_new, C_new, dt = _streams(p, x[:, 0], sp, "bd,dhp->bhp")
    packed_new = torch.cat([x_new.reshape(B, di), B_new, C_new], dim=-1)
    # rolling conv window: state holds previous W-1 packed inputs
    window = torch.cat([conv_state, packed_new[:, None, :]], dim=1)  # (B,W,C)
    new_conv_state = window[:, 1:]
    xw = window[..., :di].reshape(B, -1, sp.heads, sp.pdim)   # (B,W,H,P)
    conv_x = torch.einsum("bwhp,whp->bhp", xw, p["conv_x_w"]) + p["conv_x_b"]
    conv_B = torch.einsum("bwn,wn->bn", window[..., di:di + n],
                          p["conv_B_w"]) + p["conv_B_b"]
    conv_C = torch.einsum("bwn,wn->bn", window[..., di + n:],
                          p["conv_C_w"]) + p["conv_C_b"]
    xh = F.silu(conv_x).float()                               # (B,H,P)
    Bm = F.silu(conv_B).float()
    Cm = F.silu(conv_C).float()
    dt, A, D = _scan_params(sp, p, dt)                       # dt (B,H)
    dA = torch.exp(dt * A)                                    # (B,H)
    dBx = torch.einsum("bh,bn,bhp->bhnp", dt, Bm, xh)
    h = h * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm, h) + D[None, :, None] * xh
    y = y.to(x.dtype)
    out = _out(cfg, p, sp, (y * F.silu(z))[:, None], "bshp,hpd->bsd")
    return out, (new_conv_state, h)

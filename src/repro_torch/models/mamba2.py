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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
    di, n = cfg.d_inner, cfg.ssm_state
    return SSMState(
        torch.zeros((n_layers, batch, cfg.conv_width - 1, di + 2 * n),
                    dtype=dtype, device=device),
        torch.zeros((n_layers, batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
                    dtype=torch.float32, device=device),
    )


def _rms_norm_hp(y: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the flattened (H, P) feature dims. y: (B,S,H,P)."""
    dt = y.dtype
    y32 = y.float()
    ms = torch.mean(y32 * y32, dim=(-2, -1), keepdim=True)
    y32 = y32 * torch.rsqrt(ms + eps)
    return (y32 * (1.0 + w.float())).to(dt)


def ssd_block_train(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, return_state: bool = False):
    """Full Mamba2 block, training/prefill path. x: (B,S,D) -> (B,S,D).

    With ``return_state`` also returns (conv_state, ssm_state) at sequence
    end so prefill can hand off to O(1) decode.
    """
    B, S, _ = x.shape
    di = cfg.d_inner
    z = torch.einsum("bsd,dhp->bshp", x, p["w_z"])
    x_raw = torch.einsum("bsd,dhp->bshp", x, p["w_x"])        # (B,S,H,P)
    B_raw = x @ p["w_B"]
    C_raw = x @ p["w_C"]
    dt = x @ p["w_dt"]
    xh = _causal_conv(x_raw, p["conv_x_w"], p["conv_x_b"])
    Bm = _causal_conv(B_raw, p["conv_B_w"], p["conv_B_b"])
    Cm = _causal_conv(C_raw, p["conv_C_w"], p["conv_C_b"])
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    if cfg.use_kernels:
        # imported here, as in the reference: kernels/ssd_scan/ref.py
        # imports ssd_chunked from this module
        from repro_torch.kernels.ssd_scan.ops import ssd_scan
        y, h_final = ssd_scan(xh.float(), dt, A, Bm.float(), Cm.float(),
                              chunk=cfg.ssm_chunk, return_final=True)
    else:
        y, h_final = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                                 cfg.ssm_chunk, return_final=True)
    y = y + p["D"][None, None, :, None].float() * xh.float()
    y = y.to(x.dtype)
    y = _rms_norm_hp(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bshp,hpd->bsd", y, p["out_proj"])
    if return_state:
        W = cfg.conv_width
        # decode conv state stays packed [x | B | C] for a stable cache
        # layout
        conv_state = torch.cat(
            [x_raw[:, S - (W - 1):].reshape(B, W - 1, di),
             B_raw[:, S - (W - 1):], C_raw[:, S - (W - 1):]], dim=-1)
        return out, (conv_state, h_final)
    return out


def ssd_block_decode(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor,
                     state: Tuple[torch.Tensor, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode. x: (B,1,D); state = (conv (B,W-1,C), h (B,H,N,P))."""
    conv_state, h = state
    B = x.shape[0]
    di, n, hh, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x0 = x[:, 0]
    z = torch.einsum("bd,dhp->bhp", x0, p["w_z"])
    x_new = torch.einsum("bd,dhp->bhp", x0, p["w_x"]).reshape(B, di)
    B_new = x0 @ p["w_B"]
    C_new = x0 @ p["w_C"]
    dt = x0 @ p["w_dt"]
    packed_new = torch.cat([x_new, B_new, C_new], dim=-1)
    # rolling conv window: state holds previous W-1 packed inputs
    window = torch.cat([conv_state, packed_new[:, None, :]], dim=1)  # (B,W,C)
    new_conv_state = window[:, 1:]
    xw = window[..., :di].reshape(B, -1, hh, pd)              # (B,W,H,P)
    conv_x = torch.einsum("bwhp,whp->bhp", xw, p["conv_x_w"]) + p["conv_x_b"]
    conv_B = torch.einsum("bwn,wn->bn", window[..., di:di + n],
                          p["conv_B_w"]) + p["conv_B_b"]
    conv_C = torch.einsum("bwn,wn->bn", window[..., di + n:],
                          p["conv_C_w"]) + p["conv_C_b"]
    xh = F.silu(conv_x).float()                               # (B,H,P)
    Bm = F.silu(conv_B).float()
    Cm = F.silu(conv_C).float()
    dt = softplus(dt.float() + p["dt_bias"])                  # (B,H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                    # (B,H)
    dBx = torch.einsum("bh,bn,bhp->bhnp", dt, Bm, xh)
    h = h * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm, h) + p["D"][None, :, None] * xh
    y = y.to(x.dtype)
    y = _rms_norm_hp((y * F.silu(z))[:, None], p["gate_norm"],
                     cfg.norm_eps)[:, 0]
    out = torch.einsum("bhp,hpd->bd", y, p["out_proj"])
    return out[:, None, :], (new_conv_state, h)

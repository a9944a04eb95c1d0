"""Configuration system: architecture configs and input-shape configs.

Every assigned architecture gets one module in this package exposing
``CONFIG`` (the exact published numbers) and ``smoke()`` (a reduced config of
the same family for CPU tests).  ``repro_torch.configs.get(name)`` resolves either.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class ArchConfig:
    """Architecture hyperparameters (model topology only, no runtime knobs)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp: str = "swiglu"              # swiglu | geglu | relu2 | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 1024       # routing-group tokens (0 = one group)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64              # SSD chunk length
    conv_width: int = 4

    # --- hybrid (zamba2-style): shared attention block every k layers ---
    attn_every: int = 0

    # --- enc-dec (seamless-m4t backbone): encoder depth; n_layers = decoder ---
    enc_layers: int = 0
    # audio/vision frontends are STUBS: input_specs() provides embeddings
    frontend_len: int = 0            # frames / patches per example

    # --- dtypes ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # --- training-time knobs that affect lowering ---
    loss_chunk: int = 512            # chunked cross-entropy seq chunk
    remat: bool = True
    use_kernels: bool = False        # hand-written CUDA flash / SSD-scan paths

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:        # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    # ------------------------------------------------------------------
    # Rough parameter count (for roofline MODEL_FLOPS = 6 N D).
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d = self.d_model
        h = self.resolved_head_dim() if self.n_heads else 0
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d

        def mlp_params(ff):
            gates = 3 if self.mlp in ("swiglu", "geglu") else 2
            return gates * d * ff

        if self.family == "moe":
            n_e = (self.experts_per_token if active_only else self.n_experts)
            mlp = n_e * mlp_params(self.d_ff) + d * self.n_experts  # + router
        else:
            mlp = mlp_params(self.d_ff)

        if self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            # in_proj (x,z,B,C,dt) + out_proj + conv + A,D
            blk = d * (2 * di + 2 * ns + self.ssm_heads) + di * d \
                + self.conv_width * (di + 2 * ns) + 2 * self.ssm_heads
            per_layer = blk + d  # + norm
        elif self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            blk = d * (2 * di + 2 * ns + self.ssm_heads) + di * d \
                + self.conv_width * (di + 2 * ns) + 2 * self.ssm_heads
            per_layer = blk + mlp + 2 * d
        else:
            per_layer = attn + mlp + 2 * d

        n_blocks = self.n_layers + self.enc_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = n_blocks * per_layer + emb + d
        if self.family == "hybrid" and self.attn_every:
            total += attn + d                      # one shared attention block
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The four LM shapes shared by all 10 assigned architectures.
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k requires sub-quadratic sequence mixing: run only for SSM/hybrid.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; returns (ok, reason)."""
    if shape.name == "long_500k" and arch.family not in LONG_CONTEXT_FAMILIES:
        return False, ("skip: pure full-attention arch; long_500k needs "
                       "sub-quadratic sequence mixing (DESIGN.md §5)")
    return True, ""


@dataclass(frozen=True)
class RunConfig:
    """Runtime knobs: mesh, sharding, optimization, ScalAna."""

    arch: str = "tinyllama-1.1b"
    shape: str = "train_4k"
    multi_pod: bool = False
    microbatch: int = 0              # 0 = no gradient accumulation
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    checkpoint_dir: str = ""
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    scalana: bool = True             # graph-guided profiling on/off
    scalana_sample_every: int = 16   # region-profile every K steps
    scalana_comm_sample: float = 0.1 # comm-record sampling probability
    max_loop_depth: int = 10         # paper's MaxLoopDepth
    abnorm_thd: float = 1.3          # paper's AbnormThd
    # distributed-optimization tricks
    grad_compress: bool = False      # int8 error-feedback grad compression
    step_timeout_s: float = 0.0      # straggler guard (0 = off)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

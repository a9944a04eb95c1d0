"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block. [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,                   # MLP inside the shared attention block
    vocab_size=32000,
    mlp="gelu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,              # -> 80 SSD heads (d_inner=5120)
    ssm_chunk=64,
    conv_width=4,
    attn_every=6,                 # shared attention block every 6 layers
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        attn_every=2, loss_chunk=16,
    )

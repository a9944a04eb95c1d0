"""mamba2-130m [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,                    # attention-free
    n_kv_heads=0,
    d_ff=0,                       # no MLP; SSD block only (Mamba2 design)
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,              # -> 24 SSD heads (d_inner=1536)
    ssm_chunk=64,
    conv_width=4,
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        vocab_size=256, loss_chunk=16,
    )

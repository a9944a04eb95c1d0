"""gemma-7b [dense] — GeGLU, head_dim=256 (> d_model/n_heads). [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=128, vocab_size=256, loss_chunk=16,
    )

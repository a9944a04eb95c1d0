"""internvl2-2b [vlm] — InternViT + InternLM2 backbone. [arXiv:2404.16821]

The vision tower is a STUB: ``input_specs()`` provides precomputed patch
embeddings of shape (batch, frontend_len, d_model) prepended to the token
stream; the assigned config describes the LM backbone.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    mlp="swiglu",
    frontend_len=256,             # precomputed image patches per example
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, frontend_len=8, loss_chunk=16,
    )

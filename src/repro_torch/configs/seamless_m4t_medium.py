"""seamless-m4t-medium [audio] — enc-dec transformer backbone. [arXiv:2308.11596]

The speech/text frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings of shape (batch, frontend_len, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                  # decoder layers
    enc_layers=12,                # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    mlp="gelu",
    frontend_len=1024,            # precomputed audio frames per example
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, frontend_len=16, loss_chunk=16,
    )

"""moonshot-v1-16b-a3b [moe] — 64 experts top-6 (Moonlight-16B-A3B). [hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                    # per-expert intermediate
    vocab_size=163840,
    mlp="swiglu",
    n_experts=64,
    experts_per_token=6,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab_size=256, n_experts=8, experts_per_token=2, loss_chunk=16,
    )

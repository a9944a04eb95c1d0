"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,                   # per-expert intermediate
    vocab_size=100352,
    mlp="swiglu",
    n_experts=16,
    experts_per_token=4,
    rope_theta=500000.0,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=48,
        vocab_size=256, n_experts=4, experts_per_token=2, loss_chunk=16,
    )

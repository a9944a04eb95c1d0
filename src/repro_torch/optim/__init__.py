from repro_torch.optim.adamw import (
    AdamWState, adamw_init, adamw_update, global_norm, clip_by_global_norm,
)
from repro_torch.optim.schedule import warmup_cosine, warmup_linear, constant
from repro_torch.optim.compress import (
    compress_grads, decompress_grads, error_feedback_update,
)

__all__ = [
    "AdamWState", "adamw_init", "adamw_update",
    "global_norm", "clip_by_global_norm",
    "warmup_cosine", "warmup_linear", "constant",
    "compress_grads", "decompress_grads", "error_feedback_update",
]

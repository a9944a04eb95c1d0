"""Fused detection kernels: merge -> slope -> median -> top-k, one
logical launch each, with device-cached historical-scale columns (see
``csrc/`` and ``kernel.py`` for the CUDA kernels, ``ops.py`` for dispatch
+ launch counting, ``ref.py`` for the plain PyTorch versions)."""
from repro_torch.kernels.detect_fused.ops import (
    fused_abnormal, fused_non_scalable, fused_non_scalable_live,
    launch_counts, merge_scale_column, reset_launch_counts)

__all__ = [
    "fused_abnormal", "fused_non_scalable", "fused_non_scalable_live",
    "launch_counts", "merge_scale_column", "reset_launch_counts",
]

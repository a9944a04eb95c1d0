"""Flash attention (GQA, causal or full), forward only: the hand-written
CUDA kernel (``csrc/flash_attention.cu``, bound in ``kernel.py``), its
plain PyTorch version (``ref.py``) and the public op in the models'
layout with dispatch and launch counting (``ops.py``)."""
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, launch_counts, reset_launch_counts)

__all__ = ["flash_attention", "launch_counts", "reset_launch_counts"]

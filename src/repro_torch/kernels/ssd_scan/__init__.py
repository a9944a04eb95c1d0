"""Mamba2 SSD chunked scan, forward only: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``, bound in ``kernel.py``), its plain PyTorch
version (``ref.py``, the models' own ``ssd_chunked``) and the public op
with the reference's padding, dispatch and launch counting (``ops.py``)."""
from repro_torch.kernels.ssd_scan.ops import (
    launch_counts, reset_launch_counts, ssd_scan)

__all__ = ["launch_counts", "reset_launch_counts", "ssd_scan"]

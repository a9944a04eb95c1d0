"""Hand-written CUDA kernels for the framework's hot spots (Hopper,
``sm_90a``).

Each kernel ships as ``csrc/*.cu`` (the CUDA C++ source, plain C
interface), ``kernel.py`` (build on first use, ``ctypes`` binding,
checked wrappers with launch counts; the build itself is shared in
``_build.py``), ``ops.py`` (the public ops: CUDA
tensors to the kernel, CPU tensors to the plain version) and ``ref.py``
(the plain PyTorch version the tests and ``chip_smoke.py`` hold the
kernel against).  Nothing is compiled at import time.
"""
from repro_torch.kernels.detect_fused.ops import (
    fused_abnormal, fused_non_scalable, fused_non_scalable_live,
    merge_scale_column)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan

__all__ = ["flash_attention", "fused_abnormal", "fused_non_scalable",
           "fused_non_scalable_live", "merge_scale_column", "ssd_scan"]

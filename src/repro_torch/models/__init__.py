"""Models on torch: the dense decoder LM (tinyllama), the pure-SSM LM
(mamba2) and the Mamba2 + shared-attention hybrid (zamba2), with their
params, layers, attention (einsum, chunked, and the CUDA flash kernel
behind ``cfg.use_kernels``), the Mamba2 block (plain chunked SSD, and the
CUDA SSD-scan kernel behind ``cfg.use_kernels``), prefill and decode.
``build_model(cfg)`` is the entry point."""
from repro_torch.models.api import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]

"""Models on torch: the dense decoder LM (tinyllama) with its params,
layers, attention (einsum, chunked, and the CUDA flash kernel behind
``cfg.use_kernels``), prefill and decode.  ``build_model(cfg)`` is the
entry point."""
from repro_torch.models.api import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]

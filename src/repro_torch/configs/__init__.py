"""Architecture/shape registry.

``get(name)`` returns the full published config; ``get_smoke(name)`` returns a
reduced same-family config for CPU tests.  ``ARCHS`` lists all assigned ids,
in the JAX package's order.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ArchConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    LONG_CONTEXT_FAMILIES,
    shape_applicable,
)

_MODULES: Dict[str, str] = {
    "nemotron-4-15b": "nemotron_4_15b",
    "yi-6b": "yi_6b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "gemma-7b": "gemma_7b",
    "mamba2-130m": "mamba2_130m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-2b": "internvl2_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "dbrx-132b": "dbrx_132b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCHS: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


__all__ = [
    "ArchConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCHS",
    "LONG_CONTEXT_FAMILIES", "shape_applicable", "get", "get_smoke",
]

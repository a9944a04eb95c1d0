"""Architecture/shape registry.

``get(name)`` returns the full published config; ``get_smoke(name)`` returns a
reduced same-family config for CPU tests.  ``ARCHS`` lists the ids the port
has; ``PENDING`` the ones whose model families are not ported yet (each
config comes with its model, ROADMAP Queue 1 items 8-9).
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
    "tinyllama-1.1b": "tinyllama_1_1b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-2.7b": "zamba2_2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "dbrx-132b": "dbrx_132b",
}

ARCHS: List[str] = list(_MODULES)
PENDING: List[str] = [
    "nemotron-4-15b", "yi-6b", "gemma-7b", "seamless-m4t-medium",
    "internvl2-2b",
]


def _module(name: str):
    if name in PENDING:
        raise KeyError(f"architecture {name!r} is not ported yet "
                       f"(ROADMAP Queue 1 items 8-9); ported: {ARCHS}")
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


__all__ = [
    "ArchConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCHS", "PENDING",
    "LONG_CONTEXT_FAMILIES", "shape_applicable", "get", "get_smoke",
]

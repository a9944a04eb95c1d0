"""Uniform model API: ``build_model(cfg)`` -> ``ModelBundle``.

The bundle exposes the JAX package's entry points (init, train_loss,
prefill, decode_step, init_cache) on torch tensors, for every family the
JAX package builds: dense, moe and vlm (the transformer), ssm, hybrid
and encdec.  Everything runs on ``cuda`` unless ``device="cpu"`` is
asked for.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models.params import Specs, init_params, param_count


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    specs: Specs
    device: torch.device
    init: Callable[[torch.Generator], Any]
    train_loss: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    init_cache: Callable[[int, int], Any]

    def param_count(self) -> int:
        return param_count(self.specs)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the bundle's device seeded with ``seed``, for
        :attr:`init`."""
        return torch.Generator(device=self.device).manual_seed(seed)


def build_model(cfg: ArchConfig,
                device: Optional[torch.device | str] = None,
                moe_strategy: str = "einsum") -> ModelBundle:
    """The bundle of ``cfg``'s family on ``device`` (``cuda`` when None;
    raises where CUDA is asked for and there is no card).
    ``init(generator)`` makes fresh weights on the generator's device.
    ``moe_strategy`` ("einsum" or "sort") is the MoE family's training
    dispatch; serving always dispatches by einsum, as in the reference."""
    families = {"dense": (transformer, transformer.lm_specs),
                "moe": (transformer, transformer.lm_specs),
                "vlm": (transformer, transformer.lm_specs),
                "ssm": (ssm_lm, ssm_lm.ssm_lm_specs),
                "hybrid": (hybrid, hybrid.hybrid_specs),
                "encdec": (encdec, encdec.encdec_specs)}
    if cfg.family not in families:
        raise ValueError(f"unknown family {cfg.family!r}")
    module, specs_of = families[cfg.family]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' "
                           "to run on the host")
    pdt, cdt = cfg.pdtype(), cfg.cdtype()
    specs = specs_of(cfg)
    train_loss = functools.partial(module.train_loss, cfg)
    if module is transformer:
        train_loss = functools.partial(train_loss, moe_strategy=moe_strategy)
    return ModelBundle(
        cfg=cfg, specs=specs, device=dev,
        init=lambda generator: init_params(specs, generator, pdt),
        train_loss=train_loss,
        prefill=functools.partial(module.prefill, cfg),
        decode_step=functools.partial(module.decode_step, cfg),
        init_cache=lambda b, s: module.init_cache(cfg, b, s, cdt, dev),
    )

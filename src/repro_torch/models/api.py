"""Uniform model API: ``build_model(cfg)`` -> ``ModelBundle``.

The bundle exposes the JAX package's entry points (init, train_loss,
prefill, decode_step, init_cache) on torch tensors, for every family the
JAX package builds: dense, moe and vlm (the transformer), ssm, hybrid
and encdec.  Everything runs on ``cuda`` unless ``device="cpu"`` is
asked for.  Like the reference's, the bundle gives the launcher the
abstract parameters and inputs of a cell and their partition specs; its
abstract tensors live on the ``meta`` device, the parameters and the
serving cache as this rank's shards under the active rules.  The cache's
logical axes are the reference's; a rank's packed SSD conv state departs
from them (its x channels and the whole B and C, not a contiguous slice
of the packed dim), so its local shapes come from ``cache_specs``, not
from dividing the whole ones by their specs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.axes import use_rules
from repro_torch.models import encdec, hybrid, mamba2, ssm_lm, transformer
from repro_torch.models.attention import KVCache
from repro_torch.models.params import (Specs, abstract_params, init_params,
                                       param_count, param_specs_tree)


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

    def abstract_params(self):
        """The parameters on the ``meta`` device: this rank's shards
        under the active rules."""
        return abstract_params(self.specs, self.cfg.pdtype())

    def param_partition_specs(self):
        """PartitionSpec tree (resolved against the active mesh/rules)."""
        return param_specs_tree(self.specs)

    def cache_specs(self, batch: int, max_len: int):
        """The serving cache on the ``meta`` device: this rank's shapes
        under the active rules (its K/V heads, its SSD heads and packed
        conv channels), the whole ones without them."""
        return self.init_cache(batch, max_len, "meta")

    # ------------------------------------------------------------------
    # Abstract inputs for one (arch x shape) cell, global shapes on the
    # meta device.  Token batches carry S+1 tokens for train.
    # ------------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def t(*dims, dtype=torch.long):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "decode":
            with use_rules(None):
                return {"tokens": t(B, 1), "cache": self.cache_specs(B, S)}
        batch = {"tokens": t(B, S + 1 if shape.kind == "train" else S)}
        if cfg.family == "encdec":
            batch["frames"] = t(B, cfg.frontend_len, cfg.d_model,
                                dtype=cfg.cdtype())
        if cfg.family == "vlm":
            batch["patches"] = t(B, cfg.frontend_len, cfg.d_model,
                                 dtype=cfg.cdtype())
        return batch

    def input_logical_axes(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Logical axes matching input_specs (resolved by the launcher)."""
        cfg = self.cfg
        axes: Dict[str, Any] = {"tokens": ("batch", "seq")}
        if shape.kind != "decode":
            if cfg.family == "encdec":
                axes["frames"] = ("batch", "frontend", "embed")
            if cfg.family == "vlm":
                axes["patches"] = ("batch", "frontend", "embed")
            return axes
        kv_axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        ssm_ax = mamba2.SSMState(("layers", "batch", None, "ssm_inner"),
                                 ("layers", "batch", "ssm_heads", None, None))
        if cfg.family in ("dense", "moe", "vlm"):
            cache_ax = transformer.LMCache(KVCache(kv_axes, kv_axes,
                                                   ("batch",)))
        elif cfg.family == "encdec":
            cross = ("layers", "batch", "frontend", "kv_heads", None)
            cache_ax = encdec.EncDecCache(KVCache(kv_axes, kv_axes,
                                                  ("batch",)), cross, cross)
        elif cfg.family == "ssm":
            cache_ax = ssm_lm.SSMCache(ssm_ax, ("batch",))
        else:
            site_kv = (None, "batch", "kv_seq", "kv_heads", None)
            cache_ax = hybrid.HybridCache(ssm_ax, site_kv, site_kv,
                                          ("batch",))
        return {"tokens": ("batch", None), "cache": cache_ax}

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
    def init_cache(b, s, device=dev):
        return module.init_cache(cfg, b, s, cdt, device)

    return ModelBundle(
        cfg=cfg, specs=specs, device=dev,
        init=lambda generator: init_params(specs, generator, pdt),
        train_loss=train_loss,
        prefill=functools.partial(module.prefill, cfg),
        decode_step=functools.partial(module.decode_step, cfg),
        init_cache=init_cache,
    )

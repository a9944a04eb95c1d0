"""Device meshes over a torch process group.

``make_host_mesh`` is the twin of the JAX package's: a ``("data",
"model")`` mesh over whatever ranks the initialised process group has.
``init_group`` starts that group; ``choose_backend`` picks the backend
one host can carry: NCCL when every rank has a card of its own, else
Gloo, whose CUDA path covers the all-reduce and broadcast that the
data-parallel step needs, so several ranks may time-share one card.  The
H100 SXM data-sheet figures below are the port's roofline constants.
``make_production_mesh`` (the 16x16 and 2x16x16 meshes) and
``mesh_chip_count`` (read by the dry run) wait for ROADMAP Queue 1 item
10b.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist


def choose_backend(device: torch.device | str, world: int) -> str:
    """``nccl`` when each of ``world`` ranks can have a card of its own,
    else ``gloo`` (CUDA tensors too); ``gloo`` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_group(rank: int, world: int, init_method: str,
               device: torch.device | str = "cuda",
               timeout_s: float = 120.0,
               backend: Optional[str] = None) -> str:
    """Join the process group (rendezvous at ``init_method``, e.g. a
    ``file://`` path or ``tcp://localhost:<port>``); on a card, rank r
    uses card ``r % device_count``.  ``backend`` None means
    ``choose_backend(device, world)``; a series of scales passes the one
    its largest scale needs, so every scale runs on the same backend.
    Returns the backend."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_group: no CUDA device; pass "
                               "device='cpu' to run on the host")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = backend or choose_backend(dev, world)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_host_mesh(model_axis: int = 1, device: torch.device | str = "cuda"):
    """``(world // model_axis, model_axis)`` mesh named ``("data",
    "model")`` over the initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group; call "
                           "init_group (or init_process_group) first")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"world size {n} does not split into a model "
                         f"axis of {model_axis}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA device; pass "
                               "device='cpu' to run on the host")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM data-sheet figures (per card, dense)
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, float32 outside the tensor cores
PEAK_FLOPS_TF32 = 494.7e12      # FLOP/s, TF32 tensor cores
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores
HBM_BANDWIDTH = 3.35e12         # B/s, HBM3
NVLINK_BANDWIDTH = 900e9        # B/s, NVLink 4, total per card

"""Device meshes over a torch process group.

``make_host_mesh`` is the twin of the JAX package's: a ``("data",
"model")`` mesh over whatever ranks the initialised process group has.
``init_group`` starts that group; ``choose_backend`` picks the backend
one host can carry: NCCL when every rank has a card of its own, else
Gloo, whose CUDA path covers the all-reduce and broadcast that the
data-parallel step needs, so several ranks may time-share one card.  The
H100 SXM data-sheet figures below are the port's roofline constants.
``fake_process_group`` gives one process the ranks of a larger world for
tracing (collectives are recorded, nothing moves): the scenario recorder
traces rank 0 of 8 that way, and the production-mesh sweep
(``tools_torch/cells_sweep.py``) a rank of the reference's deployment
meshes, ``make_production_mesh``: 16x16 ``("data", "model")`` and
2x16x16 ``("pod", "data", "model")`` over 256 and 512 ranks; the dry
run (``launch/dryrun.py``) prices each such trace with
:func:`cost_analysis_dict` and these figures.  A 16x16 mesh of H100s
spans 32 nodes of eight cards (``core/fx_walk.py::NODE_CARDS``): the
``data`` axis (stride 16) always crosses nodes, a 16-way ``model`` axis
spans two, so a collective's time uses the link its group needs.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import operator
from typing import Dict, Iterator, Optional

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


@contextlib.contextmanager
def fake_process_group(world: int, rank: int = 0) -> Iterator[None]:
    """Rank ``rank`` of a ``world``-rank process group inside this one
    process (PyTorch's fake backend: a collective completes at once and
    moves nothing), for tracing a rank's program over fake tensors.  The
    group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a process group is "
                           "already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, names, device: torch.device | str, who: str):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(f"{who}: no process group; call init_group "
                           "(or init_process_group) first")
    n = dist.get_world_size()
    if n != math.prod(shape):
        raise ValueError(f"{who}: world size {n} is not a {shape} mesh")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' "
                               "to run on the host")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_host_mesh(model_axis: int = 1, device: torch.device | str = "cuda",
                   pods: int = 1):
    """``(world // model_axis, model_axis)`` mesh named ``("data",
    "model")`` over the initialised process group; with ``pods`` above 1
    ``(pods, world // (pods * model_axis), model_axis)`` named ``("pod",
    "data", "model")``, whose batch is split over pod and data."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n % (model_axis * pods):
        raise ValueError(f"world size {n} does not split into {pods} pods "
                         f"and a model axis of {model_axis}")
    if pods > 1:
        return _mesh((pods, n // (pods * model_axis), model_axis),
                     ("pod", "data", "model"), device, "make_host_mesh")
    return _mesh((n // model_axis, model_axis), ("data", "model"), device,
                 "make_host_mesh")


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str = "cuda"):
    """The reference's deployment meshes over a process group of 256 or
    512 ranks: ``(16, 16)`` named ``("data", "model")``, or with
    ``multi_pod`` ``(2, 16, 16)`` named ``("pod", "data", "model")``.  On
    one host they are traced, not run: build them under
    :func:`fake_process_group` with ``device="cpu"``."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device,
                     "make_production_mesh")
    return _mesh((16, 16), ("data", "model"), device, "make_production_mesh")


def mesh_chip_count(mesh) -> int:
    """The number of ranks (one a card) that ``mesh`` spans."""
    return int(mesh.size())


def cost_analysis_dict(traced) -> Dict[str, float]:
    """``{"flops", "bytes accessed"}`` of a traced program
    (:class:`repro_torch.core.psg.Traced`): :func:`repro_torch.core.costs.
    node_costs` summed over every ATen node of its graph, the port's
    counterpart of XLA's aggregate ``cost_analysis()`` (elementwise and
    transcendental FLOPs included, every operand and result counted)."""
    from repro_torch.core import costs
    flops = nbytes = 0.0
    for node in traced.graph_module.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        f, b = costs.node_costs(node)
        flops += f
        nbytes += b
    return {"flops": flops, "bytes accessed": nbytes}


# NVIDIA H100 SXM data-sheet figures (per card, dense)
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, float32 outside the tensor cores
PEAK_FLOPS_TF32 = 494.7e12      # FLOP/s, TF32 tensor cores
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores
HBM_BANDWIDTH = 3.35e12         # B/s, HBM3
NVLINK_BANDWIDTH = 450e9        # B/s a direction a card, NVLink 4 (900 both)
# between nodes: one 400 Gb/s NDR InfiniBand port a card (DGX H100)
IB_BANDWIDTH = 50e9             # B/s a direction a card

"""The control at a size a test run holds: the reference with its
forward products rounded to TF32 (10 mantissa bits, as the card's TF32
path rounds its inputs) against the reference in float32 reads far
above what the program reads at the same size, and the half-batch fault
too; on a card, the real TF32 path the same way."""
import pytest
import torch
from torch.overrides import TorchFunctionMode

from chipbench.harness import registry
from chipbench.reference import judge
from chipbench.reference import train as ref_train
from chipbench.tests._smoke import smoke_cell

PRODUCTS = {torch.matmul, torch.Tensor.__matmul__, torch.einsum, torch.mm,
            torch.bmm}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to 10 mantissa bits (to nearest), the gradient passed
    straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


class TF32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            args = tuple(tf32(a) if isinstance(a, torch.Tensor)
                         and a.dtype == torch.float32 else a for a in args)
        return func(*args, **(kwargs or {}))


def _readings(cell, device, emulate=False, mode="f32", half=False):
    from chipbench.harness import weights
    from chipbench.kinds.train import reference_batches
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.api import build_model
    cfg, traffic = cell["config"], cell["traffic"]
    specs = build_model(ArchConfig(**cfg["arch"]), device="cpu").specs
    batches = reference_batches(traffic, cfg["arch"]["vocab_size"],
                                cell["seed"], traffic["batch"], device)
    make = lambda: weights.make(specs, cell["seed"], device)  # noqa: E731
    kw = dict(half_batch=half, change_at=traffic["checked_steps"])
    opt = traffic["optimizer"]
    if emulate:
        with TF32Products():
            return ref_train.follow(make, batches, cfg, opt, mode, **kw)
    return ref_train.follow(make, batches, cfg, opt, mode, **kw)


def _gaps(other, ref):
    keep = ref_train.kept_leaves(ref["grad_norms"])
    return {"loss_gap": judge.loss_gap(other["losses"], ref["losses"]),
            "grad_gap": judge.leaf_gap(other["grad_norms"],
                                       ref["grad_norms"], keep)}


@pytest.mark.parametrize("config", ["mamba2-130m", "zamba2-2.7b"])
def test_control_and_fault_read_far_above_the_program(config):
    from chipbench.harness import bench
    cell = smoke_cell(config, seq_len=128, batch=2)
    sound = bench.execute(cell)["checks"]
    ref = _readings(cell, "cpu")
    control = _gaps(_readings(cell, "cpu", emulate=True), ref)
    fault = _gaps(_readings(cell, "cpu", half=True), ref)
    for name in ("loss_gap", "grad_gap"):
        assert control[name] > 10 * sound[name]["value"], (name, control)
        assert fault[name] > 10 * sound[name]["value"], (name, fault)
    limits = registry.limits(cell["workload"])
    assert any(fault[k] > limits[k] for k in fault)


@pytest.mark.cuda
def test_control_on_the_card(cuda_device):
    """The card's own TF32 path, at a small width: it reads far above
    what the program's run on the card reads at the same size."""
    from chipbench.harness import bench
    cell = dict(smoke_cell("mamba2-130m", seq_len=256, batch=2),
                device="cuda")
    sound = bench.execute(cell)["checks"]
    ref = _readings(cell, cuda_device)
    control = _gaps(_readings(cell, cuda_device, mode="tf32"), ref)
    assert any(control[k] > 10 * sound[k]["value"] for k in control), \
        (control, sound)

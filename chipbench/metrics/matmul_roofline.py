"""The matrix-product kernels' share of their roofline in the traced
steps: the configuration's matrix-product FLOPs of those steps over the
device time of the kernels of class ``matmul``
(``chipbench/kernel_classes/matmul/``), over the peak dense TF32 rate,
in %.  None where the trace holds no such kernel."""
from chipbench.harness import registry


def read(run):
    trace, peak = run.get("trace"), (run.get("peaks") or {}).get(
        "tf32_dense_flops")
    if not trace or not peak:
        return None
    pats = registry.kernel_class("matmul")
    t = sum(s for name, s in trace["by_name"].items()
            if any(p.search(name) for p in pats))
    if t <= 0:
        return None
    return 100.0 * trace["steps"] * run["flops_per_step"] / t / peak

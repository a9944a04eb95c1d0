"""The whole step's share of the chip: the configuration's matrix-product
FLOPs of the window's steps (``chipbench/flops/count.py``) over the
window's seconds, over the peak dense TF32 rate, in %."""


def read(run):
    peak = (run.get("peaks") or {}).get("tf32_dense_flops")
    if not peak or "flops" not in run or not run.get("window_s"):
        return None
    return 100.0 * run["flops"] / run["window_s"] / peak

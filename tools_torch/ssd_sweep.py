"""Development timings of the SSD kernel on the card.

At each of ``chip_smoke.py``'s full shapes (mamba2-130m's and
zamba2-2.7b's loss shapes, mamba2-130m's 32768-token prefill), CUDA-event
medians of:

* the kernel with every cluster size it takes (blocks per head and batch
  row), the wrapper's ``cluster_size`` choice marked with ``*``;
* the same kernel with its operand split rounded to nearest (the flash
  kernel's two-integer-operation rounding, built from a patched copy of
  ``csrc/ssd_scan.cu`` in the git-ignored ``build/``) beside the shipped
  truncated split, at the wrapper's cluster, in the order truncated,
  rounded, rounded, truncated, with each one's error against the plain
  version relative to max |y|.

Not part of the tests or of ``chip_smoke.py``.  Run from the repository
root on a machine with a CUDA card and the CUDA toolkit:

    python3 tools_torch/ssd_sweep.py
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TRUNCATED = ("  big = __float_as_uint(x) & TF32_MASK;\n"
             "  small = __float_as_uint(x - __uint_as_float(big)) & "
             "TF32_MASK;\n")
ROUNDED = ("  big = (__float_as_uint(x) + 0x1000u) & TF32_MASK;\n"
           "  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) "
           "& TF32_MASK;\n")


def rounded_library():
    """The kernel with the split rounded to nearest, as a second
    library built from a patched copy of the source."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel
    text = kernel.LIBRARY.source.read_text()
    if text.count(TRUNCATED) != 1:
        raise RuntimeError("ssd_scan.cu's split is not the truncated one "
                           "this script patches")
    src = _build.BUILD_DIR / "ssd_scan_rounded.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(TRUNCATED, ROUNDED))
    return _build.Library("ssd_scan_rounded", src, kernel.LIBRARY.entries)


def launch(lib, args, chunk: int, cluster: int):
    """One launch of ``lib``'s C entry with ``cluster`` blocks per (head,
    batch row); returns (y, final state)."""
    import torch
    x, dt, A, Bm, Cm = args
    B, S, H, P = x.shape
    N = Bm.shape[2]
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=x.dtype, device=x.device)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, dt, A, Bm, Cm, y, h)]
    rc = lib.entry("ssd_scan_f32")(
        *ptrs, B, S, H, P, N, chunk, cluster,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    lib.raise_on(rc, lib.name)
    return y, h


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel, ref
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    rounded = rounded_library()
    _build.build([kernel.LIBRARY, rounded])
    print(f"[ssd sweep] {cs.smi()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case in cs.SSD_FULL:
        B, S, H, _, _, Q = case
        args = cs.ssd_inputs(case, seed=sum(case))
        pick = kernel.cluster_size(B, H, S // Q, sms)
        row = []
        for cl in (1, 2, 3, 4, 8):
            ms = cs.cuda_ms(lambda: launch(kernel.LIBRARY, args, Q, cl))
            row.append(f"{cl}{'*' if cl == pick else ''}: {ms:.4f}")
        print(f"  ssd_scan {case} ms by cluster: " + ", ".join(row))
        yr = ref.ssd_ref(*args, chunk=Q)
        for name, lib in (("truncated", kernel.LIBRARY), ("rounded", rounded),
                          ("rounded", rounded), ("truncated", kernel.LIBRARY)):
            ms = cs.cuda_ms(lambda: launch(lib, args, Q, pick))
            err = cs.rel_err(launch(lib, args, Q, pick)[0], yr)
            print(f"  ssd_scan {case} split {name}: {ms:.4f} ms, y rel err "
                  f"{err:.3g} of max |y|")
        del args, yr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

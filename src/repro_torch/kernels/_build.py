"""Build and load the hand-written CUDA kernels.

Each kernel source (``csrc/*.cu``, plain C interface) is one
:class:`Library`: compiled on first use with ``nvcc`` for ``sm_90a`` into
a shared library in ``build/repro_torch/`` at the repository root (which
``.gitignore`` lists), keyed by a hash of the source and the flags, and
loaded with ``ctypes``.  :func:`build` starts one ``nvcc`` per source
not built yet, all together, so the kernels of several modules compile
in parallel.  Nothing is compiled or loaded at import time.

Shared by the kernel modules (``detect_fused/kernel.py``,
``flash_attention/kernel.py``) with their tensor checks and the CUDA
error check after each launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Sequence

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}   # library name -> loaded library
BUILD_LOG: Dict[str, str] = {}       # library name -> nvcc/ptxas report


class Library:
    """One CUDA source built into one shared library.

    ``entries`` maps each exported C function to its ``argtypes``; every
    entry returns an ``int`` CUDA error code (0 on success), and the
    source also exports ``scalana_error_string(int)``."""

    def __init__(self, name: str, source: Path, entries: Mapping[str, list],
                 extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = Path(source)
        self.entries = dict(entries)
        self.flags = ARCH_FLAGS + tuple(extra_flags)

    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def entry(self, fn: str):
        """The loaded C function ``fn``, building the library first if
        it is not loaded yet."""
        if self.name not in _LIBS:
            build([self])
        return getattr(_LIBS[self.name], fn)

    def raise_on(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = _LIBS[self.name].scalana_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME")


def build(libs: Iterable[Library]) -> Dict[str, float]:
    """Compile and load the libraries not loaded yet: one ``nvcc`` per
    source, all started together.  A library already on disk for the same
    source and flags is loaded without compiling.  Returns the seconds
    each compile took (0.0 when nothing was compiled); raises with the
    compiler's report when a build fails."""
    libs = list(libs)
    todo = [lib for lib in libs if lib.name not in _LIBS]
    spent = {lib.name: 0.0 for lib in libs}
    procs = {}
    for lib in todo:
        out = lib.path()
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *lib.flags, "-o", str(tmp), str(lib.source)]
        procs[lib.name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        report, _ = proc.communicate()
        spent[name] = time.perf_counter() - t0
        BUILD_LOG[name] = report
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{report}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for lib in todo:
        so = ctypes.CDLL(str(lib.path()))
        for fn, argtypes in lib.entries.items():
            f = getattr(so, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        so.scalana_error_string.argtypes = [ctypes.c_int]
        so.scalana_error_string.restype = ctypes.c_char_p
        _LIBS[lib.name] = so
    return spent


def check(name: str, t: torch.Tensor, dtype=None, ndim=None, shape=None,
          device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype,
    rank, shape and device (each checked where given)."""
    check_cuda(name, t, dtype=dtype, ndim=ndim, shape=shape, device=device)
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_cuda(name: str, t: torch.Tensor, dtype=None, ndim=None, shape=None,
               device=None) -> None:
    """:func:`check` without the contiguity requirement."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()

"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It puts ``src/`` (the program) and the
checkout on the path, and keeps every build and kernel cache inside the
checkout, at fixed paths under ``build/``."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "chipbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv_compute_cache")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.join(ROOT, "src"), ROOT] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]

from chipbench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

"""Build and trace every applicable (architecture x input shape) cell on
the reference's production meshes, on the CPU.

For each mesh (16x16 ``("data", "model")`` over 256 ranks and 2x16x16
``("pod", "data", "model")`` over 512) this process takes one rank of a
fake process group of that size (``launch/mesh.py::fake_process_group``:
collectives are recorded, nothing moves) and, for every config at its
published widths with its depth cut to ``--layers`` blocks (the
encoder-decoder's encoder too), every shape that ``shape_applicable``
allows and every option set (the baseline, ``gather_weights``,
``seq_shard``), runs ``build_cell(...).lower()``: the step traced over
fake tensors into its FX graph and PSG.  One line a cell (ok or the
error, the trace's seconds and its Comm vertices), then the counts.
Exits non-zero if any cell fails.

    python3 tools_torch/cells_sweep.py                # everything
    python3 tools_torch/cells_sweep.py --meshes 16x16 --archs yi-6b \\
        --shapes decode_32k --options baseline

A trace of a full-width cell takes 5-40 s here, so the whole sweep is
many minutes of one CPU core: a few GB of host memory, no tensor holds
storage.  The loop (``sweep``, ``cut``, ``cells``) lives in
``repro_torch/launch/dryrun.py``, whose dry run prices the same cells:
``python -m repro_torch.launch.dryrun --arch all --shape all --mesh
both`` writes each one's FLOPs, bytes, collectives, memory and H100
roofline to ``artifacts/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch.dryrun import MESHES, OPTIONS, sweep  # noqa: E402


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--meshes", default=",".join(MESHES))
    p.add_argument("--archs", default=",".join(ARCHS))
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--options", default=",".join(OPTIONS))
    p.add_argument("--layers", type=int, default=2)
    a = p.parse_args(argv)
    recs = []
    for rec in sweep(a.meshes.split(","), a.archs.split(","),
                     a.shapes.split(","), a.options.split(","), a.layers):
        recs.append(rec)
        print(f"{rec['mesh']:8s} {rec['arch']:22s} {rec['shape']:12s} "
              f"{rec['option']:15s} "
              + (f"ok  {rec['comms']:4d} comms" if rec["ok"]
                 else f"FAILED {rec['error']}")
              + f"  {rec['seconds']:.1f} s", flush=True)
    ok = sum(r["ok"] for r in recs)
    print(f"cells_sweep: {ok} ok, {len(recs) - ok} failed of {len(recs)} "
          f"(layers {a.layers})")
    return 0 if ok == len(recs) else 1


if __name__ == "__main__":
    sys.exit(main())

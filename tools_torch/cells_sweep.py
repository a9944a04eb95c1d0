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
storage.  The dry run reuses :func:`sweep`.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (ARCHS, SHAPES, get,  # noqa: E402
                                 shape_applicable)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.graph import COMM  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group,  # noqa: E402
                                     make_production_mesh, mesh_chip_count)

MESHES = {"16x16": False, "2x16x16": True}          # name -> multi_pod
OPTIONS = {"baseline": {}, "gather_weights": {"gather_weights": True},
           "seq_shard": {"seq_shard": True}}


def cut(cfg: ArchConfig, layers: int) -> ArchConfig:
    """``cfg`` at its published widths with at most ``layers`` blocks (and
    encoder blocks)."""
    over = {"n_layers": min(cfg.n_layers, layers)}
    if cfg.enc_layers:
        over["enc_layers"] = min(cfg.enc_layers, layers)
    return cfg.replace(**over)


def cells(archs: Iterable[str], shapes: Iterable[str]):
    """The applicable (arch, shape) pairs, in the order given."""
    for arch in archs:
        for shape in shapes:
            if shape_applicable(get(arch), SHAPES[shape])[0]:
                yield arch, shape


def sweep(meshes: Iterable[str], archs: Iterable[str],
          shapes: Iterable[str], options: Iterable[str],
          layers: int = 2) -> Iterator[Dict]:
    """Trace each cell; one record a cell: mesh, arch, shape, option,
    ``ok``, the error where it failed, the trace's seconds and the number
    of Comm vertices of its PSG."""
    todo = list(cells(archs, shapes))
    for mesh_name in meshes:
        multi = MESHES[mesh_name]
        with fake_process_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            assert mesh_chip_count(mesh) == (512 if multi else 256)
            for arch, shape in todo:
                for opt in options:
                    rec = {"mesh": mesh_name, "arch": arch, "shape": shape,
                           "option": opt}
                    t0 = time.perf_counter()
                    try:
                        cell = shardings.build_cell(
                            arch, shape, mesh, cfg=cut(get(arch), layers),
                            options=OPTIONS[opt])
                        traced = cell.lower()
                        rec.update(ok=True, comms=len(
                            traced.psg.by_kind(COMM)))
                    except Exception as e:          # noqa: BLE001
                        rec.update(ok=False,
                                   error=f"{type(e).__name__}: {e}"[:300])
                    rec["seconds"] = round(time.perf_counter() - t0, 2)
                    yield rec


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

"""Per-cell distribution auto-tuner on torch.

The twin of the JAX package's ``launch/autotune.py``.  It reads every
dry-run artifact that ``python -m repro_torch.launch.dryrun`` wrote into
one directory (``artifacts/dryrun_torch`` by default), labels each by
its options (the ``__opt-`` part of its file name: ``baseline``,
``gather_weights``, ``seq_shard`` or ``gather_weights-seq_shard``), and
recommends per (arch x shape x mesh) the variant with the lowest roofline
bound, as JSON the launcher can consume.  The bounds are the dry run's:
data-sheet H100 figures for a cluster no run has measured.

    python -m repro_torch.launch.autotune                 # report
    python -m repro_torch.launch.autotune --write plan.json
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

ARTIFACT_DIR = "artifacts/dryrun_torch"


def bound_seconds(rec: dict) -> float:
    r = rec["roofline"]
    return max(r["compute_s"], r["memory_s"], r["collective_s"])


def load_variants(artifact_dir: str = ARTIFACT_DIR
                  ) -> Dict[Tuple[str, str, str], Dict[str, dict]]:
    """``(arch, shape, mesh) -> {label: record}`` over the ``ok``
    artifacts of ``artifact_dir``."""
    cells: Dict[Tuple[str, str, str], Dict[str, dict]] = {}
    for path in sorted(glob.glob(os.path.join(artifact_dir, "*.json"))):
        m = re.search(r"__opt-([\w\-]+)\.json$", os.path.basename(path))
        label = m.group(1) if m else "baseline"
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        key = (rec["arch"], rec["shape"], rec["mesh"])
        cells.setdefault(key, {})[label] = rec
    return cells


def plan(cells) -> List[dict]:
    out = []
    for (arch, shape, mesh), variants in sorted(cells.items()):
        best = min(variants, key=lambda v: bound_seconds(variants[v]))
        base = variants.get("baseline")
        rec = variants[best]
        out.append({
            "arch": arch, "shape": shape, "mesh": mesh,
            "recommended": best,
            "bound_s": bound_seconds(rec),
            "baseline_bound_s": bound_seconds(base) if base else None,
            "speedup": (bound_seconds(base) / bound_seconds(rec)
                        if base and bound_seconds(rec) > 0 else 1.0),
            "bottleneck": rec["roofline"]["bottleneck"],
        })
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=ARTIFACT_DIR,
                    help="the dry run's artifact directory")
    ap.add_argument("--write", default="")
    args = ap.parse_args(argv)
    cells = load_variants(args.dir)
    p = plan(cells)
    for row in p:
        print(f"{row['arch']:22s} {row['shape']:12s} {row['mesh']:11s} "
              f"-> {row['recommended']:12s} bound={row['bound_s']:8.3f}s "
              f"speedup={row['speedup']:.2f}x [{row['bottleneck']}]")
    if p:
        mean = sum(r["speedup"] for r in p) / len(p)
        print(f"\nmean speedup with per-cell tuning: {mean:.2f}x "
              f"over {len(p)} cells")
    if args.write:
        with open(args.write, "w") as f:
            json.dump(p, f, indent=1)
        print(f"wrote {args.write}")


if __name__ == "__main__":
    main()

"""The port's auto-tuner (``launch/autotune.py``) against the JAX
package's (``repro.launch.autotune``, which imports no jax) on the same
synthetic dry-run records.

The reference reads two directories (``artifacts/dryrun``, whose
``__opt-`` files it labels by their options, and
``artifacts/dryrun_final``, labelled ``seq_shard``); the port reads its
one directory and labels every file by its options.  With the same
records laid out both ways the two plans are equal.
"""
import json
import os

import numpy as np

from repro.launch import autotune as ref
from repro_torch.launch import autotune

CELLS = [("tinyllama-1.1b", "train_4k", "pod16x16"),
         ("tinyllama-1.1b", "decode_32k", "pod2x16x16"),
         ("mamba2-130m", "prefill_32k", "pod16x16"),
         ("zamba2-2.7b", "long_500k", "pod16x16")]
VARIANTS = ["baseline", "gather_weights", "seq_shard"]


def _record(rng, arch, shape, mesh, variant):
    terms = {k: float(rng.uniform(0.001, 2.0))
             for k in ("compute_s", "memory_s", "collective_s")}
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "options": [] if variant == "baseline" else [variant],
            "roofline": {**terms,
                         "bottleneck": max(terms, key=terms.get)}}


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f)


def test_plan_equals_the_references(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    port_dir = tmp_path / "artifacts" / "dryrun_torch"
    for arch, shape, mesh in CELLS:
        for variant in VARIANTS:
            rec = _record(rng, arch, shape, mesh, variant)
            stem = f"{arch}__{shape}__{mesh}"
            suffix = "" if variant == "baseline" else f"__opt-{variant}"
            _write(str(port_dir / f"{stem}{suffix}.json"), rec)
            # the reference's layout: seq_shard in dryrun_final
            where = "dryrun_final" if variant == "seq_shard" else "dryrun"
            _write(str(tmp_path / "artifacts" / where
                       / f"{stem}{suffix if where == 'dryrun' else ''}"
                       ".json"), rec)
    skipped = {"arch": "yi-6b", "shape": "long_500k", "mesh": "pod16x16",
               "status": "skipped", "reason": "skip"}
    _write(str(port_dir / "yi-6b__long_500k__pod16x16.json"), skipped)
    monkeypatch.chdir(tmp_path)
    want = ref.plan(ref.load_variants())
    cells = autotune.load_variants(str(port_dir))
    got = autotune.plan(cells)
    assert got == want
    assert len(got) == len(CELLS)
    assert all(sorted(v) == sorted(VARIANTS) for v in cells.values())
    # the same records through both plans directly
    assert autotune.plan(cells) == ref.plan(cells)
    for row in got:
        assert row["recommended"] in VARIANTS
        assert row["bound_s"] <= row["baseline_bound_s"]


def test_main_writes_a_plan(tmp_path, capsys):
    rng = np.random.default_rng(1)
    for variant in VARIANTS:
        suffix = "" if variant == "baseline" else f"__opt-{variant}"
        _write(str(tmp_path / f"yi-6b__train_4k__pod16x16{suffix}.json"),
               _record(rng, "yi-6b", "train_4k", "pod16x16", variant))
    out = tmp_path / "plan.json"
    autotune.main(["--dir", str(tmp_path), "--write", str(out)])
    text = capsys.readouterr().out
    assert "mean speedup with per-cell tuning" in text
    with open(out) as f:
        plan = json.load(f)
    assert [r["arch"] for r in plan] == ["yi-6b"]
    assert plan[0]["speedup"] >= 1.0

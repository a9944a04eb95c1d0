"""The last line's shape, and the command's refusals: no card, no
program beside the benchmark."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from chipbench.harness import bench, registry
from chipbench.tests._smoke import smoke_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    cell = smoke_cell("mamba2-130m", trace=trace)
    run = bench.execute(cell)
    line = bench.result_line(cell, run, "NVIDIA H100 80GB HBM3")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % cell["traffic"]["sample_every"] == 0
    b = registry.benchmark()
    group = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in b[group]}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if not trace:
        assert set(line["metrics"]) == {"train_tokens_per_s", "mfu",
                                        "setup_s"}
    else:                   # a CPU run has no device trace to read
        assert set(line["metrics"]) == {"outside_step_ms",
                                        "profiler_overhead_frac"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def _cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         "mamba2-130m.train", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    r = _cli(ROOT)
    assert r.returncode == 2 and r.stdout == ""
    assert "needs 1 CUDA card" in r.stderr


def test_no_program_no_result(tmp_path):
    """A checkout of the benchmark alone: the run fails before any
    result (the cell's kind imports the program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "from chipbench.harness import bench;"
            "from chipbench.tests._smoke import smoke_cell;"
            "bench.execute(smoke_cell('mamba2-130m'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "repro_torch" in r.stderr

"""Every cell's files are found by name, and BENCHMARK.json keeps to the
benchmark's contract."""
import json
import math
import re

import pytest

from chipbench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_cells_find_their_files(bench):
    for wl in bench["workloads"]:
        cfg = registry.config(bench, wl["config"])
        assert cfg["name"] == wl["config"]
        traffic = registry.traffic(wl["traffic"])
        assert registry.kind(traffic["kind"]).run
        lim = registry.limits(wl["name"])
        assert lim and all(v >= 0 for v in lim.values())
        for group in ("end_to_end", "per_layer"):
            assert registry.metrics_for(bench, wl["name"], group)


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]).read)


def test_readers_return_nothing_without_input(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "setup_s":
            assert registry.metric_reader(m["name"]).read({}) is None


def test_matmul_class_matches_gemm_kernels_only():
    pats = registry.kernel_class("matmul")
    assert pats
    names = {"ampere_sgemm_128x64_nn": True,
             "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16": True,
             "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn>": True,
             "void gemv2T_kernel_val<int, int, float>": True,
             "void splitKreduce_kernel<32, 16, int, float>": True,
             "void at::native::vectorized_elementwise_kernel<4>": False,
             "void at::native::reduce_kernel<512, 1>": False}
    for name, want in names.items():
        assert any(p.search(name) for p in pats) == want, name


def test_peak_table_covers_the_card():
    row = registry.peaks("NVIDIA H100 80GB HBM3")
    assert row["tf32_dense_flops"] == pytest.approx(494.7e12)
    assert registry.peaks("some other card") is None


def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("chipbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200
    assert {c for c, _ in used} == set(names)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("host_clock", "device_trace",
                               "program_span", "program_counter")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # a full check of 24 cells fits its time
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert not math.isnan(rs)

"""The port's dry run (``launch/dryrun.py``) on the production meshes, on
the CPU.

* A cell's artifact carries every key of the JAX package's
  (``src/repro/launch/dryrun.py``'s record, read from its source: that
  module cannot be imported here, it sets ``XLA_FLAGS``) under its file
  name, with an H100 roofline and ``compile_s`` 0.
* ``--mesh both`` on one small cell writes two artifacts, ``chips`` 256
  and 512; ``--layers`` keeps the cut depth and says so.
* A cell that ``shape_applicable`` refuses writes ``status: skipped``.

The cells are mamba2-130m's decode step at its published width (the
cheapest production trace), one and two blocks deep.
"""
import json
import os
import re

from repro_torch.launch import dryrun

REF = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                   "launch", "dryrun.py")
TOP = ["arch", "shape", "mesh", "kind", "status", "options", "chips",
       "lower_s", "compile_s", "memory", "cost", "collectives", "roofline"]
NESTED = {"memory": ["argument_bytes", "output_bytes", "temp_bytes",
                     "alias_bytes", "peak_bytes"],
          "cost": ["xla_flops_raw", "xla_bytes_raw", "dot_flops_per_device",
                   "mem_bytes_per_device", "collective_bytes_per_device"],
          "collectives": ["bytes_by_kind", "counts_by_kind"],
          "roofline": ["compute_s", "memory_s", "collective_s",
                       "bottleneck"]}


def test_the_key_lists_are_the_references():
    src = open(REF).read()
    for key in TOP + [k for ks in NESTED.values() for k in ks]:
        assert f'"{key}"' in src, key
    assert '"pod2x16x16" if multi_pod else "pod16x16"' in src
    assert 'f"{arch}__{shape_name}__{mesh_name}{suffix}.json"' in src


def test_artifact_has_the_reference_keys_and_file_name(tmp_path):
    rec = dryrun.run_cell("mamba2-130m", "decode_32k", multi_pod=False,
                          out_dir=str(tmp_path), verbose=False,
                          options={"seq_shard": True})
    name = "mamba2-130m__decode_32k__pod16x16__opt-seq_shard.json"
    with open(tmp_path / name) as f:
        assert json.load(f) == rec
    for key in TOP:
        assert key in rec, key
    for part, keys in NESTED.items():
        for key in keys:
            assert key in rec[part], (part, key)
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert rec["chips"] == 256 and rec["compile_s"] == 0.0
    assert rec["options"] == ["seq_shard"]
    assert rec["depth"] == {"traced": [[1], [2]], "extrapolated_to": [24],
                            "published": [24]}
    m = rec["memory"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    r = rec["roofline"]
    assert r["bottleneck"] == max(("compute_s", "memory_s",
                                   "collective_s"), key=r.get)
    assert rec["cost"]["dot_flops_per_device"] > 0
    assert r["compute_s"] == rec["cost"]["dot_flops_per_device"] / 989e12
    assert rec["hardware"]["hbm_bandwidth"] == 3.35e12
    assert rec["collectives"]["nvlink_bytes"] + \
        rec["collectives"]["ib_bytes"] == \
        rec["cost"]["collective_bytes_per_device"]
    # a second call reads the artifact back unless told not to
    again = dryrun.run_cell("mamba2-130m", "decode_32k", multi_pod=False,
                            out_dir=str(tmp_path), verbose=False,
                            options={"seq_shard": True})
    assert again == rec


def test_mesh_both_writes_256_and_512_chips(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                 "--mesh", "both", "--layers", "1", "--out", str(tmp_path),
                 "--graph-out", str(tmp_path / "fx")])
    assert "2 ok, 0 skipped, 0 FAILED" in capsys.readouterr().out
    chips = {}
    for mesh in ("pod16x16", "pod2x16x16"):
        with open(tmp_path / f"mamba2-130m__decode_32k__{mesh}.json") as f:
            rec = json.load(f)
        chips[mesh] = rec["chips"]
        assert rec["depth"] == {"traced": [[1]], "extrapolated_to": None,
                                "published": [24]}
        assert os.path.getsize(rec["graph_path"]) > 0
    assert chips == {"pod16x16": 256, "pod2x16x16": 512}


def test_inapplicable_cell_is_skipped(tmp_path):
    rec = dryrun.run_cell("tinyllama-1.1b", "long_500k", multi_pod=True,
                          out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "skipped"
    assert re.match(r"skip: ", rec["reason"])
    with open(tmp_path / "tinyllama-1.1b__long_500k__pod2x16x16.json") as f:
        assert json.load(f) == rec

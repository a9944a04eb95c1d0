"""The port's cell assembly (``launch/shardings.py``) and scenario
recorder (``scenarios/record.py``) on the CPU.

* ``rules_for_shape`` equals the reference's for every config and shape
  in ``SHAPES`` on (16, 16) axis sizes.
* ``build_cell`` for the smoke configs of tinyllama, moonshot, mamba2,
  zamba2 and seamless: train, prefill and decode each trace for rank 0
  of a world-8 fake process group on a (4, 2) mesh, with the collectives
  of both axes as Comm vertices, the decode cache in the rank's own
  shapes (the packed SSD conv state is its x channels and the whole B
  and C, not half of the packed dim); the
  state shardings equal the reference's ``train_state_shardings`` specs
  on the same mesh (computed in a subprocess with eight forced host
  devices, the idiom of ``src/repro/scenarios/record.py``).
* ``record_train`` and ``record_decode`` write the three traces to a
  temporary directory; the port's bank loads and replays each, and each
  has the model axis's ``all-reduce`` row (pattern ``consecutive``, size
  2), as the committed reference traces do.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get as jax_get
from repro.launch import shardings as jax_shardings
from repro_torch.configs import ARCHS, SHAPES, get, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.graph import COMM
from repro_torch.distributed import axes as ax
from repro_torch.launch import shardings
from repro_torch.launch.mesh import fake_process_group, make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.params import _walk
from repro_torch.optim.tree import leaves
from repro_torch.scenarios import bank, record, source
from repro_torch.scenarios.bank import get_scenario
from repro_torch.scenarios.source import load_trace

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
REF_TRACES = os.path.join(SRC, "repro", "scenarios", "traces")
CELL_ARCHS = ("tinyllama-1.1b", "moonshot-v1-16b-a3b", "mamba2-130m",
              "zamba2-2.7b", "seamless-m4t-medium")
KINDS = (("train", "train_4k", 32), ("prefill", "prefill_32k", 16),
         ("decode", "decode_32k", 16))


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_shape_equal_the_reference(arch):
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for name, shape in SHAPES.items():
        want = jax_shardings.rules_for_shape(JAX_SHAPES[name], jax_get(arch),
                                             mesh)
        got = shardings.rules_for_shape(shape, get(arch),
                                        {"data": 16, "model": 16})
        assert got == want, (arch, name)


REF_SPECS = textwrap.dedent("""
    import json
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from repro.configs import get_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shardings import train_state_shardings
    from repro.distributed import axes as ax
    from repro.models.api import build_model

    mesh = make_host_mesh(model_axis=2)
    out = {}
    for arch in sys.argv[2:]:
        model = build_model(get_smoke(arch))
        with ax.use_rules(mesh):
            st = train_state_shardings(model, mesh)
        flat = {}
        for tag, tree in (("params", st.params), ("mu", st.opt.mu)):
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = tag + ":" + "/".join(p.key for p in path)
                flat[key] = [list(a) if isinstance(a, tuple) else a
                             for a in s.spec]
        flat["step"] = list(st.step.spec) + list(st.opt.step.spec)
        out[arch] = flat
    with open(sys.argv[1], "w") as f:
        json.dump({"mesh": dict(mesh.shape), "specs": out}, f)
""")


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("specs") / "ref.json")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", REF_SPECS, path,
                           *CELL_ARCHS], env=env, capture_output=True,
                          text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cells():
    """Every (arch, kind) cell traced for rank 0 of 8 on a (4, 2) mesh."""
    out = {}
    with fake_process_group(8):
        mesh = make_host_mesh(2, device="cpu")
        for arch in CELL_ARCHS:
            cfg = get_smoke(arch).replace(remat=False)
            for kind, name, seq in KINDS:
                cell = shardings.build_cell(arch, name, mesh, cfg=cfg,
                                            shape=ShapeConfig(name, seq, 4,
                                                              kind))
                traced = cell.lower()
                out[arch, kind] = (cell, traced.psg,
                                   shardings.train_state_shardings(
                                       cell.model, mesh))
                if kind == "decode":   # the cache the model makes a rank
                    with ax.use_rules(mesh, cell.rules):
                        out[arch, "cache"] = cell.model.init_cache(1, seq,
                                                                   "meta")
    return out


@pytest.mark.parametrize("kind", [k for k, _, _ in KINDS])
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_build_cell_traces_for_rank_0_of_8(cells, arch, kind):
    cell, psg, _ = cells[arch, kind]
    assert cell.kind == kind and cell.model.cfg.pdtype().itemsize == 2
    assert ax.axis_sizes(cell.mesh) == {"data": 4, "model": 2}
    groups = {str(v.meta["replica_groups"]) for v in psg.by_kind(COMM)}
    assert "[[0, 1]]" in groups                    # the model axis
    if kind == "train" or cell.model.cfg.family == "moe":
        assert "[[0, 2, 4, 6]]" in groups          # the data axis
    # the arguments are rank 0's: the batch split over data, the
    # parameters over model (a vocab-parallel embedding)
    args = leaves(cell.args[0].params if kind == "train" else cell.args[0])
    cfg = cell.model.cfg
    emb = (cell.args[0].params if kind == "train"
           else cell.args[0])["embed"]["embedding"]
    assert tuple(emb.shape) == (cfg.vocab_size // 2, cfg.d_model)
    assert all(t.device.type == "meta" for t in args)
    if kind == "train":
        assert cell.args[1]["tokens"].shape == (1, 33)
    if kind == "decode":           # the rank's cache, as the model makes it
        want, got = cells[arch, "cache"], cell.args[1]
        assert [t.shape for t in torch.utils._pytree.tree_leaves(got)] == \
            [t.shape for t in torch.utils._pytree.tree_leaves(want)]
        if cfg.family in ("ssm", "hybrid"):
            conv = got.ssm.conv
            assert conv.shape[-1] == cfg.d_inner // 2 + 2 * cfg.ssm_state
            assert got.ssm.h.shape[2] == cfg.ssm_heads // 2


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_train_state_shardings_equal_the_reference(cells, ref_specs, arch):
    assert ref_specs["mesh"] == {"data": 4, "model": 2}
    _, _, st = cells[arch, "train"]
    model = build_model(get_smoke(arch), device="cpu")
    names = ["/".join(p) for p, _ in _walk(model.specs)]
    want = ref_specs["specs"][arch]
    for tag, tree in (("params", st.params), ("mu", st.opt.mu)):
        got = leaves(tree)
        assert len(got) == len(names)
        for n, spec in zip(names, got):
            assert [list(a) if isinstance(a, tuple) else a
                    for a in spec] == want[f"{tag}:{n}"], (tag, n)
    assert list(st.step) + list(st.opt.step) == want["step"] == []


def test_build_cell_options_and_fallbacks():
    """Both options build and trace for rank 0 of 8 on (4, 2), each with
    its collectives: under ``gather_weights`` the rank's parameters are
    split on ``data`` too (the embedding a quarter of its rows' width) and
    the trace all-gathers them over the data group and reduce-scatters
    their gradients; under ``seq_shard`` the rules put ``res_seq`` on
    ``model`` and the trace all-gathers and reduce-scatters the sequence
    over the model group.  ``moe_sort`` picks the sort dispatch.  The
    decode fallback of KV heads that do not divide the model axis (1, 4):
    the rank's cache holds a quarter of the positions and every KV head,
    and the traced step gathers the token's query heads and all-reduces
    the partial softmax's max and sums over the model group."""
    data, model = "[[0, 2, 4, 6]]", "[[0, 1]]"

    def comms(cell):
        return {(v.comm_kind, str(v.meta["replica_groups"]))
                for v in cell.lower().psg.by_kind(COMM)}

    cfg = get_smoke("tinyllama-1.1b")
    with fake_process_group(8):
        mesh = make_host_mesh(2, device="cpu")
        shape = ShapeConfig("t", 16, 4, "train")
        cells = {opt: shardings.build_cell("tinyllama-1.1b", "train_4k",
                                           mesh, cfg=cfg, shape=shape,
                                           options={opt: True})
                 for opt in ("gather_weights", "seq_shard")}
        fsdp = comms(cells["gather_weights"])
        assert {("all_gather", data), ("reduce_scatter", data)} <= fsdp
        assert ("all_gather", model) not in fsdp
        emb = cells["gather_weights"].args[0].params["embed"]["embedding"]
        assert tuple(emb.shape) == (cfg.vocab_size // 2, cfg.d_model // 4)
        assert cells["seq_shard"].rules["res_seq"] == "model"
        seq = comms(cells["seq_shard"])
        assert {("all_gather", model), ("reduce_scatter", model)} <= seq
        assert ("all_gather", data) not in seq
        cell = shardings.build_cell(
            "moonshot-v1-16b-a3b", "train_4k", mesh,
            cfg=get_smoke("moonshot-v1-16b-a3b"), shape=shape,
            options={"moe_sort": True})
        assert cell.model.train_loss.keywords["moe_strategy"] == "sort"
    # the decode fallback of KV heads that do not divide the model axis
    with fake_process_group(4):
        mesh = make_host_mesh(4, device="cpu")
        cell = shardings.build_cell("tinyllama-1.1b", "decode_32k", mesh,
                                    cfg=cfg,
                                    shape=ShapeConfig("d", 16, 4, "decode"))
        assert (cell.rules["kv_seq"], cell.rules["kv_heads"]) == ("model",
                                                                  None)
        assert tuple(cell.args[1].kv.k.shape) == (
            cfg.n_layers, 4, 4, cfg.n_kv_heads, cfg.resolved_head_dim())
        psg = cell.lower().psg
        group = [[0, 1, 2, 3]]
        ops = [v.comm_kind for v in psg.by_kind(COMM)
               if v.meta["replica_groups"] == group]
        # per layer: the all-gathers of wk's and wv's shards (split
        # inside a head) and of the query heads, the all-reduces of the
        # max, of the sums and of wo's partial sums; the logits' gather
        assert ops.count("all_gather") == 3 * cfg.n_layers + 1
        assert ops.count("all_reduce") >= 3 * cfg.n_layers


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

REPLAY = {"tinyllama_train": "data_pipeline_stall",
          "moe_train": "moe_input_stall",
          "tinyllama_decode": "serving_batch_skew"}


def _model_rows(trace):
    return [c for c in trace.collectives
            if c.kind == "all-reduce" and c.pattern.layout == "consecutive"
            and c.pattern.size == 2]


def test_recorder_writes_traces_the_bank_replays(tmp_path, monkeypatch):
    record.main(["--out-dir", str(tmp_path), "--device", "cpu"])
    # the bank reads the recorded traces in place of the committed ones
    monkeypatch.setattr(source, "TRACE_DIR", tmp_path)
    monkeypatch.setattr(bank, "_TRACE_CACHE", {})
    for name, scenario in REPLAY.items():
        trace = load_trace(name, tmp_path)
        assert trace.mesh == {"data": 4, "model": 2}
        assert trace.recorded_devices == 8 and trace.base
        rows = _model_rows(trace)
        assert len(rows) == 1 and rows[0].count >= 1 and rows[0].bytes > 0
        # the JAX package's committed trace of that name has the row too
        assert _model_rows(load_trace(name, REF_TRACES))
        res = get_scenario(scenario).run(64, backend="numpy")
        assert res.psg.by_kind(COMM) and res.paths

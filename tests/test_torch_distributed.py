"""The port's logical-axis rules, its data-parallel step and the
multi-scale profiling workflow, on the CPU.

* ``spec_for`` / ``resolve_axis``: the twins of the reference's rule
  tests (``tests/test_hlo_shardings.py``), and the port's specs equal to
  the JAX package's for every smoke config's parameters over four mesh
  shapes (the reference resolved over a ``jax.sharding.AbstractMesh``,
  the port over the same axis sizes).
* The data-parallel step: two Gloo ranks on the CPU, each on its shard of
  the global batch, give the loss, the new parameters and the new first
  moments of the one-process step on the whole batch within 1e-5
  relative (1e-6 absolute, the tolerance of the card-vs-CPU step test),
  eager and through the profiler's sampled replay, which runs the
  all-reduce for real.  The traced PSG holds the gradient all-reduce as
  one Comm vertex; one rank under a mesh has the same vertices; no mesh,
  no Comm vertex.
* ``scaling_profile`` at scales 1 and 2: congruent PSGs, the JSON of
  every scale, and its detect equal to the numpy backend's.

Ranks are subprocesses that meet through a ``FileStore`` in ``tmp_path``
and are given a timeout, so a hang fails the test.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JaxPartitionSpec

from repro.configs import get_smoke as jax_smoke
from repro.distributed import axes as jax_axes
from repro.models.api import build_model as jax_build
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core import COMM, PSG
from repro_torch.core import psg as psg_lib
from repro_torch.data import make_dataset
from repro_torch.distributed import axes as ax
from repro_torch.launch import scaling_profile as sp
from repro_torch.models import build_model
from repro_torch.models.params import _walk
from repro_torch.optim import adamw_init
from repro_torch.optim.schedule import constant
from repro_torch.optim.tree import leaves
from repro_torch.training import TrainState, make_train_step
from repro_torch.training.trainer import to_device

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TIMEOUT_S = 120
SHAPE = ShapeConfig("dp", 16, 4, "train")     # global batch 4, 17 tokens


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------

def _mesh11():
    return {"data": 1, "model": 1}


def test_spec_for_divisibility_opt_out():
    mesh = _mesh11()
    rules = {"vocab": "model", "embed": "data"}
    assert ax.resolve_axis("vocab", 100, mesh, rules) == "model"
    spec = ax.spec_for(("vocab", "embed"), (100, 64), mesh, rules)
    assert spec == ax.PartitionSpec("model", "data")
    # on a 16-way model axis, 100 does not divide: replicated
    assert ax.resolve_axis("vocab", 100, {"data": 2, "model": 16},
                           rules) is None


def test_spec_for_no_double_axis_use():
    mesh = _mesh11()
    rules = {"a": "model", "b": "model"}
    spec = ax.spec_for(("a", "b"), (8, 8), mesh, rules)
    assert spec[0] == "model"
    assert len(spec) < 2 or spec[1] is None


def test_logical_constraint_noop_without_mesh():
    x = torch.ones(4, 4)
    assert ax.logical_constraint(x, "batch", "embed") is x
    assert ax.weight_constraint(x, "embed", "mlp") is x


def test_constraints_identity_on_data_and_raise_on_model():
    x = torch.ones(4, 4)
    with ax.use_rules({"data": 4, "model": 1}):
        assert ax.logical_constraint(x, "batch", "embed") is x
    with ax.use_rules({"data": 2, "model": 2},
                      options={"gather_weights": True}):
        with pytest.raises(NotImplementedError, match="10b"):
            ax.logical_constraint(x, "batch", "embed")
        with pytest.raises(NotImplementedError, match="10b"):
            ax.weight_constraint(x, "embed", "mlp")
    assert ax.active_mesh() is None


MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
          ((2, 4), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_param_specs_equal_the_reference(arch, mesh):
    sizes, names = mesh
    ref_mesh = AbstractMesh(sizes, names)
    mine = {path: ax.spec_for(p.axes, p.shape, dict(zip(names, sizes)),
                              ax.DEFAULT_RULES)
            for path, p in _walk(build_model(get_smoke(arch),
                                             device="cpu").specs)}
    jm = jax_build(jax_smoke(arch))
    from repro.models.params import _walk as jax_walk
    want = {path: jax_axes.spec_for(p.axes, p.shape, ref_mesh,
                                    jax_axes.DEFAULT_RULES)
            for path, p in jax_walk(jm.specs)}
    assert sorted(mine) == sorted(want)
    for path, spec in want.items():
        assert isinstance(spec, JaxPartitionSpec)
        assert tuple(mine[path]) == tuple(spec), path


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 16, "model": 16}
    spec = ax.spec_for(("embed", "mlp"), (64, 128), mesh, ax.DEFAULT_RULES)
    assert spec == ax.PartitionSpec("data", "model")
    assert ax.placements_for(spec, mesh) == (Replicate(), Shard(0), Shard(1))
    batch = ax.spec_for(("batch", "seq"), (64, 8), mesh, ax.DEFAULT_RULES)
    assert ax.placements_for(batch, mesh) == (Shard(0), Shard(0),
                                              Replicate())
    with pytest.raises(ValueError, match="DeviceMesh"):
        ax.sharding_for(("embed",), (64,), mesh)


# ---------------------------------------------------------------------------
# the data-parallel step across ranks
# ---------------------------------------------------------------------------

RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.profiler import GraphProfiler
    from repro_torch.data import make_dataset
    from repro_torch.distributed.axes import use_rules
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedule import constant
    from repro_torch.optim.tree import leaves
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.training.trainer import to_device

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    backend = init_group(rank, world, "file://" + init, device="cpu",
                         timeout_s=60)
    try:
        cfg = get_smoke("tinyllama-1.1b")
        model = build_model(cfg, device="cpu")
        params = model.init(model.generator(0))
        state = TrainState(params, adamw_init(params), None,
                           torch.zeros((), dtype=torch.int32))
        step = make_train_step(model, RunConfig(), constant(1e-3))
        data = make_dataset(cfg, ShapeConfig("dp", 16, 4, "train"))
        batch = to_device(data.shard(world, rank).batch(0), "cpu")
        with use_rules(make_host_mesh(device="cpu")):
            eager, m_eager = step(state, batch)
            prof = GraphProfiler(step, (state, batch), sample_every=1)
            sampled, m_sampled = prof.step(state, batch)
        torch.save({"backend": backend,
                    "eager": (float(m_eager["loss"]),
                              leaves(eager.params), leaves(eager.opt.mu)),
                    "sampled": (float(m_sampled["loss"]),
                                leaves(sampled.params),
                                leaves(sampled.opt.mu)),
                    "psg": prof.psg.to_json(),
                    "psg_full": prof.psg_full.to_json(),
                    "perf": {v: p.samples
                             for v, p in prof.perf_vectors().items()}},
                   out)
    finally:
        dist.destroy_process_group()
""")


def _ranks(world, tmp_path, body=RANK):
    """Run ``body`` as ``world`` ranks; each rank's saved result."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    init = str(tmp_path / f"init_{world}")
    outs = [str(tmp_path / f"rank{r}_of_{world}.pt") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", body, str(r),
                               str(world), init, outs[r]], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(o, weights_only=False) for o in outs]


def _one_process_step():
    """The step on the whole global batch, no mesh, no collective."""
    cfg = get_smoke("tinyllama-1.1b")
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    state = TrainState(params, adamw_init(params), None,
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, RunConfig(), constant(1e-3))
    batch = to_device(make_dataset(cfg, SHAPE).batch(0), "cpu")
    new, metrics = step(state, batch)
    return (float(metrics["loss"]), leaves(new.params),
            leaves(new.opt.mu)), step, state, batch, model


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    return {1: _ranks(1, tmp), 2: _ranks(2, tmp)}


def _all_reduce_line() -> int:
    from repro_torch.training import trainer
    with open(trainer.__file__) as f:
        return next(i for i, line in enumerate(f, start=1)
                    if "funcol.all_reduce(" in line)


@pytest.mark.parametrize("path", ["eager", "sampled"])
def test_two_rank_step_equals_the_one_process_step(dp_runs, path):
    (loss, params, mu), *_ = _one_process_step()
    for rank in dp_runs[2]:
        assert rank["backend"] == "gloo"
        got_loss, got_params, got_mu = rank[path]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        for name, got, want in (("params", got_params, params),
                                ("mu", got_mu, mu)):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=name)


def test_the_all_reduce_is_one_comm_vertex(dp_runs):
    model = build_model(get_smoke("tinyllama-1.1b"), device="cpu")
    for world, ranks in dp_runs.items():
        for key in ("psg", "psg_full"):
            psg = PSG.from_json(ranks[0][key])
            comms = psg.by_kind(COMM)
            assert len(comms) == 1, (world, key)
            v = comms[0]
            assert v.name == "all_reduce" and v.comm_kind == "all_reduce"
            assert v.comm_bytes == 4 * (model.param_count() + 1)
            assert v.meta["replica_groups"] == [list(range(world))]
            assert v.source.endswith(
                f"repro_torch/training/trainer.py:{_all_reduce_line()}")
            assert v.parent == psg.root
            # the wait is folded in: no Comp vertex named wait_tensor
            assert not [u for u in psg.vertices if u.name == "wait_tensor"]
        # the sampled replay timed the collective
        psg = PSG.from_json(ranks[0]["psg"])
        assert ranks[0]["perf"][psg.by_kind(COMM)[0].vid] == 1


def test_psgs_are_congruent_across_ranks_counts(dp_runs):
    for key in ("psg", "psg_full"):
        psgs = {w: PSG.from_json(r[0][key]) for w, r in dp_runs.items()}
        sp.check_congruent(psgs)
        assert len(psgs[1].vertices) == len(psgs[2].vertices)


def test_step_without_a_mesh_has_no_comm_vertex():
    _, step, state, batch, _ = _one_process_step()
    traced = psg_lib.trace(step, state, batch)
    assert traced.psg.by_kind(COMM) == []
    assert not any(n.op == "call_function" and "c10d" in str(n.target)
                   for n in traced.graph_module.graph.nodes)


def test_congruence_check_raises_on_a_different_psg(dp_runs):
    a = PSG.from_json(dp_runs[1][0]["psg"])
    b = PSG.from_json(dp_runs[2][0]["psg"])
    b.vertices[3].name = "not_" + b.vertices[3].name
    with pytest.raises(ValueError, match="scales 1 and 2 differ"):
        sp.check_congruent({1: a, 2: b})


TRAINER_RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.training import Trainer

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    init_group(rank, world, "file://" + init, device="cpu", timeout_s=60)
    try:
        run = RunConfig(total_steps=3, warmup_steps=1, learning_rate=1e-3,
                        scalana=True, scalana_sample_every=2)
        tr = Trainer(run, mesh=make_host_mesh(device="cpu"),
                     arch_cfg=get_smoke("tinyllama-1.1b"),
                     shape=ShapeConfig("dp", 16, 4, "train"), device="cpu")
        state = tr.train(num_steps=3)
        sh = tr.state_shardings(state)
        torch.save({"losses": [m["loss"] for m in tr.metrics_log],
                    "local_batch": tr.dataset.local_batch,
                    "comm": tr.profiler.psg.stats()["Comm"],
                    "embed": repr(sh.params["embed"]["embedding"][1]),
                    "step": repr(sh.step[1])}, out)
    finally:
        dist.destroy_process_group()
""")


def test_trainer_over_two_ranks_equals_one_process(tmp_path):
    """The Trainer with a mesh reads each rank's shard and trains like the
    one-process Trainer on the whole batch (losses within 1e-5); its
    placements shard ``embed`` on ``data``, as the reference's rules do."""
    from repro_torch.training import Trainer
    run = RunConfig(total_steps=3, warmup_steps=1, learning_rate=1e-3,
                    scalana=False)
    one = Trainer(run, arch_cfg=get_smoke("tinyllama-1.1b"), shape=SHAPE,
                  device="cpu")
    one.train(num_steps=3)
    want = [m["loss"] for m in one.metrics_log]
    for rank in _ranks(2, tmp_path, TRAINER_RANK):
        assert rank["local_batch"] == 2 and rank["comm"] == 1
        np.testing.assert_allclose(rank["losses"], want, rtol=1e-5)
        # ("vocab", "embed") -> PartitionSpec("model", "data")
        assert rank["embed"] == "(Shard(dim=1), Shard(dim=0))"
        assert rank["step"] == "(Replicate(), Replicate())"


# ---------------------------------------------------------------------------
# the multi-scale workflow
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scaling_dir(tmp_path_factory):
    """Scales 1 and 2 of the smoke tinyllama, measured once, on Gloo."""
    out = str(tmp_path_factory.mktemp("scaling"))
    kw = dict(arch="tinyllama-1.1b", steps=4, batch=4, seq=16,
              sample_every=2, out_dir=out, device="cpu",
              timeout_s=TIMEOUT_S, backend="gloo")
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for n in (1, 2):
            sp.run_scale(n, **kw)
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return out


def test_scaling_profile_on_the_cpu(scaling_dir):
    for n in (1, 2):
        with open(sp.scale_path(scaling_dir, "tinyllama-1.1b", n)) as f:
            raw = json.load(f)
        assert raw["n_procs"] == n and raw["backend"] == "gloo"
        assert raw["config"] == "smoke" and raw["peak_bytes"] == [None] * n
        assert raw["trace_s"] > 0
        assert len(raw["perf_procs"]) == n and raw["perf"] == \
            raw["perf_procs"][0]
    psgs, series, _ = sp.load_series("tinyllama-1.1b", [1, 2], scaling_dir)
    assert sorted(series) == [1, 2]
    for n, psg in psgs.items():
        (comm,) = psg.by_kind(COMM)
        assert comm.meta["replica_groups"] == [list(range(n))]
        # every rank's row measured the all-reduce, twice (steps 2 and 4)
        assert (series[n].perf.samples[:, comm.vid] == 2).all()
    want = sp.diagnose(series, backend="numpy")
    got = sp.diagnose(series, backend="torch", device="cpu")
    assert [d.vid for d in got[0]] == [d.vid for d in want[0]]
    for a, b in zip(got[0], want[0]):        # f64 slope fits: 1e-12
        assert abs(a.slope - b.slope) <= 1e-12 * max(abs(b.slope), 1.0)
        assert abs(a.share - b.share) <= 1e-12 * max(abs(b.share), 1.0)
    assert got[1] == want[1]
    assert [p.nodes for p in got[2]] == [p.nodes for p in want[2]]


@pytest.mark.parametrize("key,value", [("backend", "nccl"),
                                       ("config", "full")])
def test_scaling_series_needs_one_backend_and_config(scaling_dir, tmp_path,
                                                     key, value):
    """A series whose scales ran on different backends (or configs) mixes
    that change with the change of scale: load_series refuses it."""
    import shutil
    out = str(tmp_path / "series")
    shutil.copytree(scaling_dir, out)
    path = sp.scale_path(out, "tinyllama-1.1b", 2)
    with open(path) as f:
        raw = json.load(f)
    raw[key] = value
    with open(path, "w") as f:
        json.dump(raw, f)
    with pytest.raises(ValueError, match=f"different {key}s"):
        sp.load_series("tinyllama-1.1b", [1, 2], out)


def test_scaling_profile_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.main(["--scales", "1"])

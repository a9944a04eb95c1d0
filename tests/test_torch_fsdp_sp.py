"""FSDP storage (``gather_weights``), sequence parallelism (``seq_shard``)
and the pod axis on the CPU, against the one-process step.

Ranks are Gloo subprocesses.  One module-scoped fixture per mesh runs
every case of that mesh in one set of rank processes:

* ``("data", "model")`` (2, 2): the smoke configs of tinyllama and
  moonshot under ``gather_weights``, ``seq_shard`` and both (the
  residual stream of 16 positions split on seq over the model axis); the
  traced tinyllama step under both, whose PSG holds the data axis's
  all-gathers and reduce-scatters and the sequence's as Comm vertices;
* ``("pod", "data", "model")`` (2, 2, 1): tinyllama and moonshot with no
  option: the batch is split over pod and data, and the step averages
  over both (one bucket over the flattened pod-and-data group, which the
  mesh's installation makes, outside any trace); the traced moonshot
  step holds that bucket and the MoE means as Comm vertices over the
  pod-and-data ranks.

Each step's loss, MoE metrics and first moments (gathered from the
shards) match the one-process step on the whole batch as
``_step_check`` holds them.  Under ``gather_weights`` a rank's
parameters are split on ``data`` where ``spec_for`` puts their ``embed``
dim there.  A subprocess with four forced host devices runs the JAX
package's step under the same options on its (2, 2) mesh, and the
port's tinyllama step under both options matches it.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.graph import COMM, PSG
from repro_torch.data import make_dataset
from repro_torch.distributed import axes as ax
from repro_torch.models import build_model
from repro_torch.models.params import _walk
from repro_torch.optim import adamw_init
from repro_torch.optim.schedule import constant
from repro_torch.optim.tree import leaves
from repro_torch.training import TrainState, make_train_step
from repro_torch.training.trainer import to_device

from _step_check import assert_first_step_close, run_ranks

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SHAPE = ShapeConfig("fsdp", 16, 4, "train")   # global batch 4, 17 tokens
MOE_METRICS = ("moe_aux_loss", "moe_z_loss", "moe_drop_frac")
OPTS = ("gw", "sp", "gw+sp")
TRANSFORMERS = ("tinyllama-1.1b", "moonshot-v1-16b-a3b")
# mesh (pods, data, model) -> cases (arch, options) and the traced case
MESHES = {(1, 2, 2): ([(a, o) for a in TRANSFORMERS for o in OPTS],
                      ("tinyllama-1.1b", "gw+sp")),
          (2, 2, 1): ([(a, "") for a in TRANSFORMERS],
                      ("moonshot-v1-16b-a3b", ""))}

# One rank: each case's step under its rules and options (``gw``:
# gather_weights, ``sp``: res_seq on model), its state gathered whole.
RANK = textwrap.dedent("""
    import json
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core import psg as psg_lib
    from repro_torch.data import make_dataset
    from repro_torch.distributed import axes as ax
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import _walk
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedule import constant
    from repro_torch.optim.tree import leaves
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.training.trainer import to_device

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    pods, model_axis = int(sys.argv[5]), int(sys.argv[6])
    cases, traced = json.loads(sys.argv[7]), json.loads(sys.argv[8])
    init_group(rank, world, "file://" + init, device="cpu", timeout_s=120)
    res = {}
    try:
        mesh = make_host_mesh(model_axis, device="cpu", pods=pods)
        shard = ax.batch_coord(mesh)
        for arch, opts in cases:
            cfg = get_smoke(arch)
            model = build_model(cfg, device="cpu")
            specs = [s for _, s in _walk(model.specs)]
            rules = (dict(ax.DEFAULT_RULES, res_seq="model")
                     if "sp" in opts else None)
            options = {"gather_weights": "gw" in opts}
            with ax.use_rules(mesh, rules, options):
                def whole(tree):
                    return [ax.gather_shards(t, s.axes, s.shape)
                            for t, s in zip(leaves(tree), specs)]

                params = model.init(model.generator(0))
                state = TrainState(params, adamw_init(params), None,
                                   torch.zeros((), dtype=torch.int32))
                step = make_train_step(model, RunConfig(), constant(1e-3))
                data = make_dataset(cfg, ShapeConfig("fsdp", 16, 4, "train"))
                batch = to_device(data.shard(*shard).batch(0), "cpu")
                new, m = step(state, batch)
                r = {"loss": float(m["loss"]),
                     "metrics": {k: float(v) for k, v in m.items()
                                 if k.startswith("moe_")},
                     "params": whole(new.params), "mu": whole(new.opt.mu),
                     "nu": whole(new.opt.nu),
                     "local": [tuple(t.shape) for t in leaves(params)],
                     "mu_local": [tuple(t.shape)
                                  for t in leaves(new.opt.mu)]}
                if [arch, opts] == traced:
                    r["psg"] = psg_lib.trace(step, state, batch).psg.to_json()
            res[arch + ":" + opts] = r
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """One set of rank processes per mesh (``request.param``)."""
    pods, d, m = request.param
    cases, traced = MESHES[request.param]
    tmp = tmp_path_factory.mktemp("fsdp_" + "x".join(map(str, request.param)))
    return run_ranks(RANK, pods * d * m, tmp,
                     (pods, m, json.dumps(cases), json.dumps(traced)))


_ONE: dict = {}


def one_process(arch):
    """The step on the whole batch with no mesh."""
    if arch not in _ONE:
        cfg = get_smoke(arch)
        model = build_model(cfg, device="cpu")
        params = model.init(model.generator(0))
        state = TrainState(params, adamw_init(params), None,
                           torch.zeros((), dtype=torch.int32))
        step = make_train_step(model, RunConfig(), constant(1e-3))
        batch = to_device(make_dataset(cfg, SHAPE).batch(0), "cpu")
        new, m = step(state, batch)
        _ONE[arch] = {"loss": float(m["loss"]), "metrics": m,
                      "old": leaves(params), "mu": leaves(new.opt.mu),
                      "specs": [s for _, s in _walk(model.specs)]}
    return _ONE[arch]


def check_step(r, want):
    np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
    for k in [k for k in MOE_METRICS if k in want["metrics"]]:
        np.testing.assert_allclose(r["metrics"][k], float(want["metrics"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert_first_step_close(r["params"], r["mu"], r["nu"], want["old"],
                            want["mu"])


def storage(specs, mesh, opts):
    """Per leaf, whether ``gather_weights`` stores it split on data, and
    its local shape, on a mesh of axis sizes ``mesh``."""
    with ax.use_rules(mesh, None, {"gather_weights": "gw" in opts}):
        return ([ax.data_dim(s.axes, s.shape) is not None for s in specs],
                [ax.local_shape(s.axes, s.shape) for s in specs])


def _cases():
    return [(mesh, arch, opts) for mesh, (cases, _) in MESHES.items()
            for arch, opts in cases]


def _ids(cases):
    return ["x".join(map(str, m)) + f"-{a}-{o or 'baseline'}"
            for m, a, o in cases]


@pytest.mark.parametrize("runs,arch,opts", _cases(), ids=_ids(_cases()),
                         indirect=["runs"], scope="module")
def test_step_equals_the_one_process_step(runs, arch, opts):
    want = one_process(arch)
    pods, d, m = runs_mesh = [k for k, (c, _) in MESHES.items()
                              if (arch, opts) in c][0]
    sizes = {"data": d, "model": m, **({"pod": pods} if pods > 1 else {})}
    split, local = storage(want["specs"], sizes, opts)
    _, base = storage(want["specs"], sizes, "")
    assert any(split) == ("gw" in opts), runs_mesh
    for rank in runs:
        r = rank[f"{arch}:{opts}"]
        check_step(r, want)
        # storage: parameters and moments alike; a data-split leaf holds
        # half of its baseline shard
        assert r["local"] == r["mu_local"] == local
        for spl, loc, b in zip(split, local, base):
            assert np.prod(loc) * (d if spl else 1) == np.prod(b)


def _comms(g):
    return g.by_kind(COMM)


@pytest.mark.parametrize("runs", [(1, 2, 2)], ids=["1x2x2"], indirect=True,
                         scope="module")
def test_the_psg_shows_the_data_and_sequence_collectives(runs):
    """The traced tinyllama step under both options on (2, 2): the
    data axis's all-gathers (forward) and reduce-scatters (backward) of
    the data-split weights, over rank r's data group, and the sequence's
    all-gathers and reduce-scatters over its model group, all at lines of
    ``distributed/axes.py``; one data-side all-reduce (the bucket) at the
    root, from ``training/trainer.py``."""
    for r, rank in enumerate(runs):
        g = PSG.from_json(rank["tinyllama-1.1b:gw+sp"]["psg"])
        data_group = [[r % 2, r % 2 + 2]]
        model_group = [[r - r % 2, r - r % 2 + 1]]
        kinds = {}
        for v in _comms(g):
            groups = v.meta["replica_groups"]
            axis = ("data" if groups == data_group else
                    "model" if groups == model_group else str(groups))
            kinds.setdefault((axis, v.comm_kind), []).append(v)
        for key in (("data", "all_gather"), ("data", "reduce_scatter"),
                    ("model", "all_gather"), ("model", "reduce_scatter")):
            assert kinds.get(key), (key, sorted(kinds))
            for v in kinds[key]:
                path = v.source.rpartition(":")[0]
                assert path.endswith(os.path.join("repro_torch",
                                                  "distributed", "axes.py"))
        trainer = os.path.join("repro_torch", "training", "trainer.py")
        buckets = [v for vs in kinds.values() for v in vs
                   if v.source.rpartition(":")[0].endswith(trainer)]
        assert len(buckets) == 1 and buckets[0].comm_kind == "all_reduce"
        assert buckets[0].meta["replica_groups"] == data_group


# ---------------------------------------------------------------------------
# against the JAX package's four-host-device step
# ---------------------------------------------------------------------------

JAX_STEP = textwrap.dedent("""
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_smoke
    from repro.configs.base import RunConfig
    from repro.distributed import axes as ax
    from repro.launch.mesh import make_host_mesh
    from repro.models.api import build_model
    from repro.optim import adamw_init
    from repro.optim.schedule import constant
    from repro.training.trainer import TrainState, make_train_step

    out = sys.argv[1]
    assert jax.device_count() == 4
    cfg = get_smoke("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
    mesh = make_host_mesh(model_axis=2)
    rules = dict(ax.DEFAULT_RULES, res_seq="model")
    step = make_train_step(model, RunConfig(), constant(1e-3))
    with ax.use_rules(mesh, rules, {"gather_weights": True}):
        state = TrainState(params=params, opt=adamw_init(params),
                           residual=None, step=jnp.zeros((), jnp.int32))
        new, metrics = jax.jit(step)(state, {"tokens": jnp.asarray(tokens)})
    flat = {"tokens": tokens, "loss": np.asarray(metrics["loss"]),
            "mesh": np.asarray([mesh.shape["data"], mesh.shape["model"]])}
    for tag, tree in (("init", params), ("mu", new.opt.mu)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(p.key for p in path)
            flat[tag + ":" + key] = np.asarray(leaf)
    np.savez(out, **flat)
""")

JAX_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import params_from_reference
    from repro_torch.distributed import axes as ax
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import _walk, local_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedule import constant
    from repro_torch.optim.tree import leaves
    from repro_torch.training import TrainState, make_train_step

    rank, world, init, out, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
    init_group(rank, world, "file://" + init, device="cpu", timeout_s=120)
    try:
        z = np.load(ref)
        tree = {}
        for key in z.files:
            if key.startswith("init:"):
                node = tree
                *parts, last = key[len("init:"):].split("/")
                for p in parts:
                    node = node.setdefault(p, {})
                node[last] = z[key]
        model = build_model(get_smoke("tinyllama-1.1b"), device="cpu")
        mesh = make_host_mesh(2, device="cpu")
        rules = dict(ax.DEFAULT_RULES, res_seq="model")
        n, i = ax.batch_coord(mesh)
        tokens = torch.from_numpy(z["tokens"]).long()
        with ax.use_rules(mesh, rules, {"gather_weights": True}):
            params = local_params(params_from_reference(tree, "cpu"),
                                  model.specs)
            state = TrainState(params, adamw_init(params), None,
                               torch.zeros((), dtype=torch.int32))
            step = make_train_step(model, RunConfig(), constant(1e-3))
            rows = tokens.shape[0] // n
            new, m = step(state, {"tokens": tokens[i * rows:(i + 1) * rows]})
            specs = [s for _, s in _walk(model.specs)]

            def whole(tree):
                return [ax.gather_shards(t, s.axes, s.shape)
                        for t, s in zip(leaves(tree), specs)]

            torch.save({"loss": float(m["loss"]), "params": whole(new.params),
                        "mu": whole(new.opt.mu), "nu": whole(new.opt.nu),
                        "names": ["/".join(p) for p, _ in _walk(model.specs)]},
                       out)
    finally:
        dist.destroy_process_group()
""")


def test_fsdp_sp_step_equals_the_jax_four_device_step(tmp_path):
    """The JAX package's f32 smoke tinyllama step on four forced host
    devices under ``use_rules(make_host_mesh(model_axis=2), res_seq on
    model, gather_weights)`` (GSPMD partitions it), and the port's (2, 2)
    step under both options on the same weights and tokens: the loss
    within 1e-5, the moments and new parameters as
    ``assert_first_step_close`` holds them."""
    ref = str(tmp_path / "jax_step.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", JAX_STEP, ref], env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    z = np.load(ref)
    assert list(z["mesh"]) == [2, 2]
    for rank in run_ranks(JAX_RANK, 4, tmp_path, (ref,)):
        np.testing.assert_allclose(rank["loss"], float(z["loss"]), rtol=1e-5)
        old = [torch.from_numpy(z["init:" + n]) for n in rank["names"]]
        want_mu = [torch.from_numpy(z["mu:" + n]) for n in rank["names"]]
        assert_first_step_close(rank["params"], rank["mu"], rank["nu"], old,
                                want_mu)


@pytest.mark.parametrize("runs", [(2, 2, 1)], ids=["2x2x1"], indirect=True,
                         scope="module")
def test_the_pod_and_data_bucket_is_one_comm_vertex(runs):
    """The traced moonshot step on (2, 2, 1) (its trace flattens no
    sub-mesh): one data-side all-reduce at the root, from
    ``training/trainer.py``, over the four pod-and-data ranks; the MoE
    load-balance means over the same group."""
    trainer = os.path.join("repro_torch", "training", "trainer.py")
    for rank in runs:
        g = PSG.from_json(rank["moonshot-v1-16b-a3b:"]["psg"])
        comms = _comms(g)
        buckets = [v for v in comms
                   if v.source.rpartition(":")[0].endswith(trainer)]
        assert len(buckets) == 1 and buckets[0].comm_kind == "all_reduce"
        assert buckets[0].meta["replica_groups"] == [[0, 1, 2, 3]]
        means = [v for v in comms if v is not buckets[0]
                 and v.meta["replica_groups"] == [[0, 1, 2, 3]]]
        assert means

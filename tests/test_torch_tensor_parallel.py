"""The port's tensor-parallel layer on the CPU, against the one-process
step.

Ranks are Gloo subprocesses on a ``("data", "model")`` mesh, each holding
its parameter shards (``init`` under the rules draws every leaf whole
from the seed's stream and keeps its slice).  One module-scoped fixture
per mesh shape runs every config in one set of rank processes:

* (1, 2): every smoke config of the dense, MoE and VLM families; greedy
  prefill plus decode for tinyllama and moonshot; the traced tinyllama
  step's PSG;
* (2, 2) over 4 ranks: tinyllama and moonshot (data and model axes);
* (1, 4): tinyllama, whose 2 KV heads do not divide the axis (its
  ``wk``/``wv`` shards are gathered at use).

Each step's loss, MoE metrics and first moments (gathered from the
shards) match the one-process step on the whole batch within 1e-5
relative (1e-6 absolute), and its new parameters are AdamW's first step
from its own moments within 1e-6 (``_step_check``, which says why the
parameters are not held against the one-process step's directly).  A
subprocess with two forced host devices runs the JAX package's step
under its ``model_axis=2`` mesh on the same weights and batch, and the
port's (1, 2) step matches it the same way.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.graph import COMM, LOOP, PSG
from repro_torch.data import make_dataset
from repro_torch.distributed import axes as ax
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.optim.schedule import constant
from repro_torch.optim.tree import leaves
from repro_torch.training import TrainState, make_train_step
from repro_torch.training.trainer import to_device

from _step_check import assert_first_step_close

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TIMEOUT_S = 240
SHAPE = ShapeConfig("tp", 16, 4, "train")     # global batch 4, 17 tokens
FAMILIES = ("tinyllama-1.1b", "nemotron-4-15b", "yi-6b", "gemma-7b",
            "internvl2-2b", "moonshot-v1-16b-a3b", "dbrx-132b")
DECODE = ("tinyllama-1.1b", "moonshot-v1-16b-a3b")
MESHES = {(1, 2): FAMILIES, (2, 2): ("tinyllama-1.1b", "moonshot-v1-16b-a3b"),
          (1, 4): ("tinyllama-1.1b",)}
MOE_METRICS = ("moe_aux_loss", "moe_z_loss", "moe_drop_frac")
PROMPT, NEW = (2, 8), 5

RANK = textwrap.dedent("""
    import sys
    import numpy as np
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
    model_axis, archs = int(sys.argv[5]), sys.argv[6].split(",")
    decode = sys.argv[7].split(",")
    init_group(rank, world, "file://" + init, device="cpu", timeout_s=120)
    res = {}
    try:
        mesh = make_host_mesh(model_axis, device="cpu")
        nd, dr = mesh["data"].size(), mesh.get_local_rank("data")
        for arch in archs:
            cfg = get_smoke(arch)
            model = build_model(cfg, device="cpu")
            specs = [s for _, s in _walk(model.specs)]

            def whole(tree):
                return [ax.gather_shards(t, s.axes, s.shape)
                        for t, s in zip(leaves(tree), specs)]

            with ax.use_rules(mesh):
                params = model.init(model.generator(0))
                state = TrainState(params, adamw_init(params), None,
                                   torch.zeros((), dtype=torch.int32))
                step = make_train_step(model, RunConfig(), constant(1e-3))
                data = make_dataset(cfg, ShapeConfig("tp", 16, 4, "train"))
                batch = to_device(data.shard(nd, dr).batch(0), "cpu")
                new, m = step(state, batch)
                r = {"loss": float(m["loss"]),
                     "metrics": {k: float(v) for k, v in m.items()
                                 if k.startswith("moe_")},
                     "params": whole(new.params), "mu": whole(new.opt.mu),
                     "nu": whole(new.opt.nu),
                     "local": [tuple(t.shape) for t in leaves(params)]}
                if arch in decode:
                    g = np.random.default_rng(7)
                    prompt = torch.from_numpy(g.integers(
                        0, cfg.vocab_size, size=%r)).long()
                    logits, cache = model.prefill(params, {"tokens": prompt},
                                                  prompt.shape[1] + %d)
                    toks = []
                    for _ in range(%d):
                        tok = torch.argmax(logits[:, -1], -1)[:, None]
                        toks.append(tok)
                        logits, cache = model.decode_step(params, cache, tok)
                    r["tokens"] = torch.cat(toks, 1)
                    r["cache_heads"] = cache.kv.k.shape[3]
                if arch == "tinyllama-1.1b":
                    r["psg"] = psg_lib.trace(step, state, batch).psg.to_json()
            res[arch] = r
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
""" % (PROMPT, NEW, NEW))


def _ranks(world, tmp_path, args=(), body=RANK):
    """Run ``body`` as ``world`` ranks; each rank's saved result."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    init = str(tmp_path / f"init_{world}")
    outs = [str(tmp_path / f"rank{r}_of_{world}.pt") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", body, str(r),
                               str(world), init, outs[r], *map(str, args)],
                              env=env, stdout=subprocess.PIPE,
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


@pytest.fixture(scope="module")
def tp_runs(request, tmp_path_factory):
    """One set of rank processes per mesh shape (``request.param``),
    running every config of that shape."""
    d, m = request.param
    archs = MESHES[request.param]
    tmp = tmp_path_factory.mktemp("tp_" + "x".join(map(str, request.param)))
    decode = [a for a in DECODE if a in archs and request.param == (1, 2)]
    return request.param, _ranks(d * m, tmp,
                                 (m, ",".join(archs), ",".join(decode)))


_ONE: dict = {}


def _one_process(arch):
    """The step, and greedy prefill + decode, on the whole batch with no
    mesh: the reference every rank is held against."""
    if arch in _ONE:
        return _ONE[arch]
    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    state = TrainState(params, adamw_init(params), None,
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, RunConfig(), constant(1e-3))
    batch = to_device(make_dataset(cfg, SHAPE).batch(0), "cpu")
    new, m = step(state, batch)
    out = {"loss": float(m["loss"]), "metrics": m,
           "old": leaves(params), "mu": leaves(new.opt.mu),
           "shapes": [tuple(t.shape) for t in leaves(params)]}
    if arch in DECODE:
        g = np.random.default_rng(7)
        prompt = torch.from_numpy(g.integers(0, cfg.vocab_size,
                                             size=PROMPT)).long()
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      PROMPT[1] + NEW)
        toks = []
        for _ in range(NEW):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks.append(tok)
            logits, cache = model.decode_step(params, cache, tok)
        out["tokens"] = torch.cat(toks, 1)
    _ONE[arch] = out
    return out


def _cases():
    return [(mesh, arch) for mesh, archs in MESHES.items() for arch in archs]


def _ids(cases):
    return [f"{'x'.join(map(str, m))}-{a}" for m, a in cases]


@pytest.mark.parametrize("tp_runs,arch", _cases(), ids=_ids(_cases()),
                         indirect=["tp_runs"], scope="module")
def test_tensor_parallel_step_equals_the_one_process_step(tp_runs, arch):
    _, ranks = tp_runs
    want = _one_process(arch)
    for rank in ranks:
        r = rank[arch]
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        for k in [k for k in MOE_METRICS if k in want["metrics"]]:
            np.testing.assert_allclose(r["metrics"][k],
                                       float(want["metrics"][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert_first_step_close(r["params"], r["mu"], r["nu"], want["old"],
                                want["mu"])
        # the rank held shards: some leaf is smaller than the whole one
        assert any(tuple(a) != b for a, b in zip(r["local"], want["shapes"]))


@pytest.mark.parametrize("tp_runs,arch", [((1, 2), a) for a in DECODE],
                         ids=list(DECODE), indirect=["tp_runs"],
                         scope="module")
def test_tensor_parallel_greedy_decode_gives_the_one_process_tokens(
        tp_runs, arch):
    """Prefill and decode on local heads, experts and vocab columns (the
    logits gathered): the one-process greedy tokens, the cache holding the
    rank's K/V heads."""
    _, ranks = tp_runs
    want = _one_process(arch)
    cfg = get_smoke(arch)
    for rank in ranks:
        assert torch.equal(rank[arch]["tokens"], want["tokens"])
        assert rank[arch]["cache_heads"] == cfg.n_kv_heads // 2


def _comms(g, vid):
    return [g.vertices[k] for k in g.children(vid)
            if g.vertices[k].kind == COMM]


@pytest.mark.parametrize("tp_runs", [(1, 2)], ids=["1x2"], indirect=True,
                         scope="module")
def test_the_psg_shows_the_tensor_parallel_collectives(tp_runs):
    """The traced (1, 2) tinyllama step (remat on).  Per layer, forward:
    the all-reduce of ``x @ wo`` and of ``h @ w_down`` (row-parallel) = 2.
    Backward loop body: the backward all-reduce of the two column-parallel
    inputs (attention's and the MLP's ``copy_to_model``), plus the
    recompute's attention all-reduce = 3 (the checkpoint's recompute stops
    once the tensors the backward saved are back: the block's last
    product, the MLP's all-reduce, is not among them).  Per loss chunk:
    the max, the sum of exponentials and the picked logit = 3; none in its
    backward.  At the root: the data bucket over rank 0's data group [0],
    the embedding's all-reduce, the final hidden state's backward
    all-reduce, and the gradient and parameter norms."""
    _, ranks = tp_runs
    for r, rank in enumerate(ranks):
        g = PSG.from_json(rank["tinyllama-1.1b"]["psg"])
        loops = {g.vertices[v].name: v for v in g.children(g.root)
                 if g.vertices[v].kind == LOOP}
        want = {"scan:layers": 2, "scan:layers.grad": 3,
                "scan:loss_chunks": 3, "scan:loss_chunks.grad": 0}
        assert {n: len(_comms(g, loops[n])) for n in want} == want
        for name in want:
            for v in _comms(g, loops[name]):
                assert v.comm_kind == "all_reduce"
                assert v.meta["replica_groups"] == [[0, 1]]
                path = v.source.rpartition(":")[0]
                assert os.path.join("src", "repro_torch", "distributed",
                                    "") in path, v.source
        root = _comms(g, g.root)
        data = [v for v in root if v.meta["replica_groups"] == [[r]]]
        assert len(data) == 1 and data[0].comm_kind == "all_reduce"
        assert data[0].source.rpartition(":")[0].endswith(
            os.path.join("repro_torch", "training", "trainer.py"))
        assert len(root) == 5
        assert all(v.meta["replica_groups"] == [[0, 1]]
                   for v in root if v is not data[0])


# ---------------------------------------------------------------------------
# against the JAX package's two-host-device step
# ---------------------------------------------------------------------------

JAX_STEP = textwrap.dedent("""
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
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
    assert jax.device_count() == 2
    cfg = get_smoke("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
    mesh = make_host_mesh(model_axis=2)
    step = make_train_step(model, RunConfig(), constant(1e-3))
    with ax.use_rules(mesh):
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
    from repro_torch.models.params import _walk
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
        params = params_from_reference(tree, "cpu", specs=model.specs,
                                       mesh=mesh)
        with ax.use_rules(mesh):
            state = TrainState(params, adamw_init(params), None,
                               torch.zeros((), dtype=torch.int32))
            step = make_train_step(model, RunConfig(), constant(1e-3))
            new, m = step(state, {"tokens": torch.from_numpy(
                z["tokens"]).long()})
            specs = [s for _, s in _walk(model.specs)]
            torch.save({"loss": float(m["loss"]),
                        "params": [ax.gather_shards(t, s.axes, s.shape)
                                   for t, s in zip(leaves(new.params), specs)],
                        "mu": [ax.gather_shards(t, s.axes, s.shape)
                               for t, s in zip(leaves(new.opt.mu), specs)],
                        "nu": [ax.gather_shards(t, s.axes, s.shape)
                               for t, s in zip(leaves(new.opt.nu), specs)],
                        "names": ["/".join(p) for p, _ in _walk(model.specs)]},
                       out)
    finally:
        dist.destroy_process_group()
""")


def test_tensor_parallel_step_equals_the_jax_two_device_step(tmp_path):
    """The JAX package's f32 smoke tinyllama step under
    ``use_rules(make_host_mesh(model_axis=2))`` on two forced host devices
    (GSPMD partitions it), and the port's (1, 2) step on the same weights
    and tokens: the loss within 1e-5, the moments and new parameters as
    ``assert_first_step_close`` holds them."""
    ref = str(tmp_path / "jax_step.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", JAX_STEP, ref], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stderr[-3000:]
    z = np.load(ref)
    assert list(z["mesh"]) == [1, 2]
    for rank in _ranks(2, tmp_path, (ref,), JAX_RANK):
        np.testing.assert_allclose(rank["loss"], float(z["loss"]), rtol=1e-5)
        old = [torch.from_numpy(z["init:" + n]) for n in rank["names"]]
        want_mu = [torch.from_numpy(z["mu:" + n]) for n in rank["names"]]
        assert_first_step_close(rank["params"], rank["mu"], rank["nu"], old,
                                want_mu)

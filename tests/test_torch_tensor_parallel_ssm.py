"""The port's tensor-parallel layer for the SSM, hybrid and
encoder-decoder families on the CPU, against the one-process step.

Ranks are Gloo subprocesses on a ``("data", "model")`` mesh, each holding
its parameter shards, as in ``tests/test_torch_tensor_parallel.py``.  One
module-scoped fixture per mesh shape runs every config of that shape in
one set of rank processes:

* (1, 2): the smoke configs of mamba2-130m, zamba2-2.7b and
  seamless-m4t-medium; the traced mamba2 and zamba2 steps' PSGs;
* (1, 4): mamba2 and zamba2 (SSD heads split), a mamba2 variant of
  d_model 48 whose 6 heads do not divide the axis (the ``ssm_pdim``
  split: every head on a quarter of its width), and seamless with a
  vocabulary of 258, which does not divide the axis (the embedding and
  the loss stay whole on every rank);
* (2, 2) over 4 ranks: mamba2.

Each step's loss, first moments (gathered from the shards) and new
parameters are held against the one-process step on the whole batch as
``_step_check`` holds them (1e-5 relative, 1e-6 absolute), and greedy
prefill plus decode gives the one process's tokens from a cache of the
rank's own shapes.  A subprocess with two forced host devices runs the
JAX package's step under its ``model_axis=2`` mesh on the same weights
and batch for mamba2 and seamless, and the port's (1, 2) step matches it
the same way.
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
from repro_torch.core.graph import BRANCH, COMM, LOOP, PSG
from repro_torch.data import make_dataset
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
MAMBA, ZAMBA, SEAMLESS = "mamba2-130m", "zamba2-2.7b", "seamless-m4t-medium"
# name -> (config, smoke overrides)
CONFIGS = {MAMBA: (MAMBA, {}), ZAMBA: (ZAMBA, {}), SEAMLESS: (SEAMLESS, {}),
           "mamba2-pdim": (MAMBA, {"d_model": 48}),
           "seamless-vocab258": (SEAMLESS, {"vocab_size": 258})}
MESHES = {(1, 2): (MAMBA, ZAMBA, SEAMLESS),
          (1, 4): (MAMBA, ZAMBA, "mamba2-pdim", "seamless-vocab258"),
          (2, 2): (MAMBA,)}
TRACED = (MAMBA, ZAMBA)
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
    from repro_torch.models import attention, build_model
    from repro_torch.models import mamba2
    from repro_torch.models.layers import vocab_shard
    from repro_torch.models.params import _walk
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedule import constant
    from repro_torch.optim.tree import leaves
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.training.trainer import to_device

    CONFIGS, PROMPT, NEW, TRACED = %r, %r, %d, %r
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    model_axis, names = int(sys.argv[5]), sys.argv[6].split(",")
    init_group(rank, world, "file://" + init, device="cpu", timeout_s=120)
    res = {}

    # the cache's leaves gathered over the model axis and repacked into
    # the one-process layout: the x channels of the packed conv state (in
    # head order; under the P split each head's slices in order), the SSM
    # state's heads or P slices, the K/V heads
    def whole_cache(cfg, cache):
        flat = torch.utils._pytree.tree_leaves(cache)
        out = []
        if cfg.family in ("ssm", "hybrid"):
            sp, (conv, h), flat = mamba2.split(cfg), flat[:2], flat[2:]
            x, bc = conv[..., :sp.inner], conv[..., sp.inner:]
            if sp.tp:
                x = ax.gather_from_model(x.contiguous(), x.dim() - 1)
                if sp.dim == 2:
                    lead, m = x.shape[:-1], ax.model_size()
                    x = x.reshape(*lead, m, sp.heads, sp.pdim).transpose(
                        -3, -2).reshape(*lead, -1)
                h = ax.gather_from_model(h, 2 if sp.dim == 1 else 4)
            out += [torch.cat([x, bc], -1), h]
        split_kv = cfg.n_heads and attention.heads(cfg).kv == "local"
        for t in flat:
            out.append(ax.gather_from_model(t.contiguous(), 3)
                       if t.dim() == 5 and split_kv else t)
        return out

    try:
        mesh = make_host_mesh(model_axis, device="cpu")
        nd, dr = mesh["data"].size(), mesh.get_local_rank("data")
        for name in names:
            arch, over = CONFIGS[name]
            cfg = get_smoke(arch).replace(**over)
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
                     "params": whole(new.params), "mu": whole(new.opt.mu),
                     "nu": whole(new.opt.nu),
                     "local": [tuple(t.shape) for t in leaves(params)],
                     "split": tuple(mamba2.split(cfg))
                     if cfg.family in ("ssm", "hybrid") else None,
                     "vocab_shard": vocab_shard(cfg)}
                g = np.random.default_rng(7)
                prompt = {"tokens": torch.from_numpy(g.integers(
                    0, cfg.vocab_size, size=PROMPT)).long()}
                if cfg.family == "encdec":
                    prompt["frames"] = torch.from_numpy(g.standard_normal(
                        (PROMPT[0], cfg.frontend_len, cfg.d_model)
                    ).astype(np.float32))
                logits, cache = model.prefill(params, prompt,
                                              PROMPT[1] + NEW)
                r["prefill_cache"] = whole_cache(cfg, cache)
                toks = []
                for _ in range(NEW):
                    tok = torch.argmax(logits[:, -1], -1)[:, None]
                    toks.append(tok)
                    logits, cache = model.decode_step(params, cache, tok)
                r["tokens"] = torch.cat(toks, 1)
                r["cache"] = [tuple(t.shape) for t in
                              torch.utils._pytree.tree_leaves(cache)]
                r["cache_specs"] = [tuple(t.shape) for t in
                                    torch.utils._pytree.tree_leaves(
                                        model.cache_specs(PROMPT[0],
                                                          PROMPT[1] + NEW))]
                if name in TRACED and model_axis == 2:
                    r["psg"] = psg_lib.trace(step, state, batch).psg.to_json()
            res[name] = r
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
""" % (CONFIGS, PROMPT, NEW, TRACED))


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
    tmp = tmp_path_factory.mktemp("tp_" + "x".join(map(str, request.param)))
    return request.param, _ranks(d * m, tmp,
                                 (m, ",".join(MESHES[request.param])))


def _cfg(name):
    arch, over = CONFIGS[name]
    return get_smoke(arch).replace(**over)


_ONE: dict = {}


def _one_process(name):
    """The step, and greedy prefill + decode, on the whole batch with no
    mesh: the reference every rank is held against."""
    if name in _ONE:
        return _ONE[name]
    cfg = _cfg(name)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    state = TrainState(params, adamw_init(params), None,
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, RunConfig(), constant(1e-3))
    batch = to_device(make_dataset(cfg, SHAPE).batch(0), "cpu")
    new, m = step(state, batch)
    out = {"loss": float(m["loss"]), "old": leaves(params),
           "mu": leaves(new.opt.mu),
           "shapes": [tuple(t.shape) for t in leaves(params)]}
    g = np.random.default_rng(7)
    prompt = {"tokens": torch.from_numpy(g.integers(
        0, cfg.vocab_size, size=PROMPT)).long()}
    if cfg.family == "encdec":
        prompt["frames"] = torch.from_numpy(g.standard_normal(
            (PROMPT[0], cfg.frontend_len, cfg.d_model)).astype(np.float32))
    logits, cache = model.prefill(params, prompt, PROMPT[1] + NEW)
    # a copy: decode writes its K/V into the cache's buffers in place
    out["prefill_cache"] = [t.clone() for t in
                            torch.utils._pytree.tree_leaves(cache)]
    toks = []
    for _ in range(NEW):
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
    out["tokens"] = torch.cat(toks, 1)
    _ONE[name] = out
    return out


def _cases():
    return [(mesh, name) for mesh, names in MESHES.items() for name in names]


def _ids(cases):
    return [f"{'x'.join(map(str, m))}-{a}" for m, a in cases]


@pytest.mark.parametrize("tp_runs,name", _cases(), ids=_ids(_cases()),
                         indirect=["tp_runs"], scope="module")
def test_tensor_parallel_step_equals_the_one_process_step(tp_runs, name):
    (_, m), ranks = tp_runs
    want = _one_process(name)
    cfg = _cfg(name)
    for rank in ranks:
        r = rank[name]
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        assert_first_step_close(r["params"], r["mu"], r["nu"], want["old"],
                                want["mu"])
        # the rank held shards: some leaf is smaller than the whole one
        assert any(tuple(a) != b for a, b in zip(r["local"], want["shapes"]))
        if cfg.family in ("ssm", "hybrid"):      # the split the rules pick
            h, p = cfg.ssm_heads, cfg.ssm_head_dim
            assert r["split"] == ((1, h // m, p) if h % m == 0
                                  else (2, h, p // m))
        assert (r["vocab_shard"] is None) == (cfg.vocab_size % m != 0)


@pytest.mark.parametrize("tp_runs,name", _cases(), ids=_ids(_cases()),
                         indirect=["tp_runs"], scope="module")
def test_tensor_parallel_greedy_decode_gives_the_one_process_tokens(
        tp_runs, name):
    """Prefill and decode on the rank's SSD heads (or P slice), attention
    heads and vocab columns (the logits gathered): the one-process greedy
    tokens, from caches of the rank's own shapes, which ``cache_specs``
    gives under the rules."""
    (_, m), ranks = tp_runs
    want = _one_process(name)
    cfg = _cfg(name)
    for rank in ranks:
        r = rank[name]
        assert torch.equal(r["tokens"], want["tokens"])
        assert r["cache"] == r["cache_specs"]
        if cfg.family in ("ssm", "hybrid"):  # packed conv [x | B | C], h
            h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            hl, pl = (h // m, p) if h % m == 0 else (h, p // m)
            assert r["cache"][0] == (cfg.n_layers, PROMPT[0],
                                     cfg.conv_width - 1, hl * pl + 2 * n)
            assert r["cache"][1] == (cfg.n_layers, PROMPT[0], hl, n, pl)
        if cfg.family == "encdec":   # self K, V, length, cross K, V
            nkv = cfg.n_kv_heads // m
            assert [c[3] for c in r["cache"] if len(c) == 5] == [nkv] * 4


@pytest.mark.parametrize("tp_runs,name", _cases(), ids=_ids(_cases()),
                         indirect=["tp_runs"], scope="module")
def test_the_gathered_prefill_cache_equals_the_one_process_cache(
        tp_runs, name):
    """Each rank's prefill cache, gathered over ``model`` and repacked (a
    rank's packed conv state is ``[its x channels | B | C]``, not a
    contiguous slice of the whole one), equals the one-process cache:
    each leaf within 1e-5 of its largest magnitude (the residual stream's
    round-off, partial sums added in another order, carried through the
    layers, shows in projections that cancel to near zero)."""
    _, ranks = tp_runs
    want = _one_process(name)["prefill_cache"]
    for rank in ranks:
        got = rank[name]["prefill_cache"]
        assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
        for i, (g, w) in enumerate(zip(got, want)):
            if not w.is_floating_point():       # the lengths
                assert torch.equal(g, w)
                continue
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-5 * scale, i


def _comms(g, vid):
    return [g.vertices[k] for k in g.children(vid)
            if g.vertices[k].kind == COMM]


def _descendants(g, vid):
    out, todo = [], list(g.children(vid))
    while todo:
        k = todo.pop()
        out.append(k)
        todo.extend(g.children(k))
    return out


def _loops(g):
    return {g.vertices[v].name: v for v in g.children(g.root)
            if g.vertices[v].kind == LOOP}


def _model_axis_comm(v):
    assert v.meta["replica_groups"] == [[0, 1]]
    path = v.source.rpartition(":")[0]
    assert os.path.join("src", "repro_torch", "distributed", "") in path, \
        v.source


@pytest.mark.parametrize("tp_runs", [(1, 2)], ids=["1x2"], indirect=True,
                         scope="module")
def test_the_psg_shows_the_ssd_block_collectives(tp_runs):
    """The traced (1, 2) mamba2 step (remat on).  Per layer, forward: the
    gate norm's sum of squares and ``out_proj``'s partial sums, two
    all-reduces.  Backward loop body: the backward all-reduces of the
    column-parallel input, of B and C before the scan and of the norm's
    sum, plus the recompute's forward all-reduces."""
    _, ranks = tp_runs
    for rank in ranks:
        g = PSG.from_json(rank[MAMBA]["psg"])
        loops = _loops(g)
        fwd = _comms(g, loops["scan:layers"])
        assert len(fwd) == 2
        bwd = _comms(g, loops["scan:layers.grad"])
        assert len(bwd) >= 3
        for v in fwd + bwd:
            assert v.comm_kind == "all_reduce"
            _model_axis_comm(v)


@pytest.mark.parametrize("tp_runs", [(1, 2)], ids=["1x2"], indirect=True,
                         scope="module")
def test_the_psg_shows_the_shared_block_collectives_in_the_branch(tp_runs):
    """The traced (1, 2) zamba2 step: the shared attention + MLP block's
    all-reduces (``wo`` and ``w_down`` row-parallel) are Comm vertices
    inside the Branch of the forward layer Loop, and the backward Loop's
    Branch holds collectives too; the SSD block's sit in the Loop body."""
    _, ranks = tp_runs
    for rank in ranks:
        g = PSG.from_json(rank[ZAMBA]["psg"])
        loops = _loops(g)
        for name in ("scan:layers", "scan:layers.grad"):
            inner = _descendants(g, loops[name])
            branches = [k for k in inner if g.vertices[k].kind == BRANCH]
            assert branches, name
            in_branch = [g.vertices[k] for b in branches
                         for k in _descendants(g, b)
                         if g.vertices[k].kind == COMM]
            assert len(in_branch) >= 2, name
            for v in in_branch:
                _model_axis_comm(v)
        (fb,) = [k for k in g.children(loops["scan:layers"])
                 if g.vertices[k].kind == BRANCH]
        assert len([k for k in _descendants(g, fb)
                    if g.vertices[k].kind == COMM]) == 2
        assert len(_comms(g, loops["scan:layers"])) == 2


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

    out, arch = sys.argv[1], sys.argv[2]
    assert jax.device_count() == 2
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    g = np.random.default_rng(3)
    batch = {"tokens": g.integers(0, cfg.vocab_size,
                                  size=(4, 17)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = g.standard_normal(
            (4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    mesh = make_host_mesh(model_axis=2)
    step = make_train_step(model, RunConfig(), constant(1e-3))
    with ax.use_rules(mesh):
        state = TrainState(params=params, opt=adamw_init(params),
                           residual=None, step=jnp.zeros((), jnp.int32))
        new, metrics = jax.jit(step)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = {"batch:" + k: v for k, v in batch.items()}
    flat["loss"] = np.asarray(metrics["loss"])
    flat["mesh"] = np.asarray([mesh.shape["data"], mesh.shape["model"]])
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

    rank, world, init, out, ref, arch = (int(sys.argv[1]), int(sys.argv[2]),
                                         sys.argv[3], sys.argv[4],
                                         sys.argv[5], sys.argv[6])
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
        model = build_model(get_smoke(arch), device="cpu")
        mesh = make_host_mesh(2, device="cpu")
        params = params_from_reference(tree, "cpu", specs=model.specs,
                                       mesh=mesh)
        batch = {k[len("batch:"):]: torch.from_numpy(z[k])
                 for k in z.files if k.startswith("batch:")}
        batch["tokens"] = batch["tokens"].long()
        with ax.use_rules(mesh):
            state = TrainState(params, adamw_init(params), None,
                               torch.zeros((), dtype=torch.int32))
            step = make_train_step(model, RunConfig(), constant(1e-3))
            new, m = step(state, batch)
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


@pytest.mark.parametrize("arch", [MAMBA, SEAMLESS])
def test_tensor_parallel_step_equals_the_jax_two_device_step(tmp_path, arch):
    """The JAX package's f32 smoke step under
    ``use_rules(make_host_mesh(model_axis=2))`` on two forced host devices
    (GSPMD partitions it), and the port's (1, 2) step on the same weights
    and batch: the loss within 1e-5, the moments and new parameters as
    ``assert_first_step_close`` holds them."""
    ref = str(tmp_path / "jax_step.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", JAX_STEP, ref, arch],
                          env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stderr[-3000:]
    z = np.load(ref)
    assert list(z["mesh"]) == [1, 2]
    for rank in _ranks(2, tmp_path, (ref, arch), JAX_RANK):
        np.testing.assert_allclose(rank["loss"], float(z["loss"]), rtol=1e-5)
        old = [torch.from_numpy(z["init:" + n]) for n in rank["names"]]
        want_mu = [torch.from_numpy(z["mu:" + n]) for n in rank["names"]]
        assert_first_step_close(rank["params"], rank["mu"], rank["nu"], old,
                                want_mu)

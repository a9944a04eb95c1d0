"""The sequence-split decode cache on the CPU: the GQA fallback and
long-context serving, against one process and the JAX package.

* **The GQA fallback.**  The tinyllama smoke config's 2 KV heads do not
  divide a model axis of 4, so ``rules_for_shape`` puts the cache's
  positions on ``model`` (``kv_seq``) and keeps every KV head on every
  rank.  Four Gloo ranks on (1, 4) prefill a (2, 8) prompt into a cache
  of 16 positions (4 a rank) and greedy-decode 5 tokens: each token's
  K/V is written by the rank that holds its slot, and each rank attends
  over its positions with the token's query heads gathered, the partial
  softmaxes combined by an all-reduce of the max and one of the sums.
  The tokens equal the port's one process's and the JAX package's
  (``jax.jit`` prefill and decode under the same rules on four forced
  host devices, GSPMD partitioning them), and the ranks' caches gathered
  on positions equal the one-process cache.
* **Long context.**  ``long_500k``'s rules put the positions on the
  batch axes.  Two Gloo ranks on a ``("data", "model")`` (2, 1) mesh
  serve the zamba2 smoke config (batch 1, whole on both ranks) from a
  cache of 32 positions: a 20-token prompt fills positions on both ranks,
  then 5 greedy tokens (the shared attention's partial softmax over the
  data group) equal one process's, and so do the gathered caches.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_smoke
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model

from _step_check import run_ranks

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
FALLBACK = "tinyllama-1.1b"
PROMPT, NEW, MAX_LEN = (2, 8), 5, 16
LONG = "zamba2-2.7b"
LONG_PROMPT, LONG_LEN = 20, 32

JAX_DECODE = textwrap.dedent("""
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_smoke
    from repro.configs.base import ShapeConfig
    from repro.distributed import axes as ax
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shardings import rules_for_shape
    from repro.models.api import build_model

    out, prompt_shape, new, max_len = (sys.argv[1], eval(sys.argv[2]),
                                       int(sys.argv[3]), int(sys.argv[4]))
    cfg = get_smoke("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=prompt_shape).astype(np.int32)
    mesh = make_host_mesh(model_axis=4)
    rules = rules_for_shape(ShapeConfig("d", max_len, prompt_shape[0],
                                        "decode"), cfg, mesh)
    assert rules["kv_seq"] == "model" and rules["kv_heads"] is None
    prefill = jax.jit(model.prefill, static_argnums=2)
    decode = jax.jit(model.decode_step)
    with ax.use_rules(mesh, rules):
        logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)},
                                max_len)
        toks = []
        for _ in range(new):
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, cache = decode(params, cache, tok)
    flat = {"prompt": prompt, "tokens": np.concatenate(toks, 1),
            "mesh": np.asarray([mesh.shape["data"], mesh.shape["model"]])}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["init:" + "/".join(p.key for p in path)] = np.asarray(leaf)
    np.savez(out, **flat)
""")

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import SHAPES, get_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import params_from_reference
    from repro_torch.distributed import axes as ax
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.launch.shardings import rules_for_shape
    from repro_torch.models import build_model
    from repro_torch.models.params import local_params

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    arch, model_axis, ref = sys.argv[5], int(sys.argv[6]), sys.argv[7]
    prompt_shape, new, max_len = eval(sys.argv[8]), int(sys.argv[9]), \\
        int(sys.argv[10])
    init_group(rank, world, "file://" + init, device="cpu", timeout_s=120)
    try:
        cfg = get_smoke(arch)
        model = build_model(cfg, device="cpu")
        mesh = make_host_mesh(model_axis, device="cpu")
        if ref:                                  # the GQA fallback
            z = np.load(ref)
            tree = {}
            for key in z.files:
                if key.startswith("init:"):
                    node = tree
                    *parts, last = key[len("init:"):].split("/")
                    for p in parts:
                        node = node.setdefault(p, {})
                    node[last] = z[key]
            whole = params_from_reference(tree, "cpu")
            prompt = torch.from_numpy(z["prompt"]).long()
            rules = rules_for_shape(ShapeConfig("d", max_len,
                                                prompt_shape[0], "decode"),
                                    cfg, mesh)
        else:                                    # long-context serving
            whole = model.init(model.generator(0))
            prompt = torch.from_numpy(np.random.default_rng(7).integers(
                0, cfg.vocab_size, size=prompt_shape)).long()
            rules = rules_for_shape(SHAPES["long_500k"], cfg, mesh)
        res = {"rules": {k: rules[k] for k in ("kv_seq", "kv_heads")}}
        with ax.use_rules(mesh, rules), torch.no_grad():
            params = local_params(whole, model.specs)
            logits, cache = model.prefill(params, {"tokens": prompt}, max_len)
            toks = []
            for _ in range(new):
                tok = torch.argmax(logits[:, -1], -1)[:, None]
                toks.append(tok)
                logits, cache = model.decode_step(params, cache, tok)
            axes, _ = ax.rule_axes("kv_seq")
            group = ax.group_of(axes)[0]
            kv = cache.kv if hasattr(cache, "kv") else cache
            res["local"] = tuple(kv.k.shape)
            res["k"] = ax._gathered(kv.k, 2, group)
            res["v"] = ax._gathered(kv.v, 2, group)
            res["tokens"] = torch.cat(toks, 1)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
""")


def _greedy(model, params, prompt, new, max_len):
    logits, cache = model.prefill(params, {"tokens": prompt}, max_len)
    toks = []
    for _ in range(new):
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
    kv = cache.kv if hasattr(cache, "kv") else cache
    return torch.cat(toks, 1), kv.k, kv.v


@pytest.fixture(scope="module")
def fallback(tmp_path_factory):
    """The JAX package's tokens and weights, and the four ranks'."""
    tmp = tmp_path_factory.mktemp("fallback")
    ref = str(tmp / "jax_decode.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", JAX_DECODE, ref,
                           repr(PROMPT), str(NEW), str(MAX_LEN)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    ranks = run_ranks(RANK, 4, tmp, (FALLBACK, 4, ref, repr(PROMPT), NEW,
                                     MAX_LEN))
    return np.load(ref), ranks


def test_gqa_fallback_decode_gives_the_one_process_and_jax_tokens(fallback):
    z, ranks = fallback
    assert list(z["mesh"]) == [1, 4]
    tree = {}
    for key in z.files:
        if key.startswith("init:"):
            node = tree
            *parts, last = key[len("init:"):].split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = z[key]
    cfg = get_smoke(FALLBACK)
    model = build_model(cfg, device="cpu")
    params = params_from_reference(tree, "cpu")
    with torch.no_grad():
        tokens, k, v = _greedy(model, params,
                               torch.from_numpy(z["prompt"]).long(), NEW,
                               MAX_LEN)
    np.testing.assert_array_equal(tokens.numpy(), z["tokens"])
    for r in ranks:
        assert r["rules"] == {"kv_seq": "model", "kv_heads": None}
        # the rank's cache: a quarter of the positions, every KV head
        assert r["local"] == (cfg.n_layers, PROMPT[0], MAX_LEN // 4,
                              cfg.n_kv_heads, cfg.resolved_head_dim())
        assert torch.equal(r["tokens"], tokens)
        # a decoded token's K/V come from layers after a partial softmax,
        # whose sums run in another order: within 1e-5 absolute
        np.testing.assert_allclose(r["k"].numpy(), k.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["v"].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_long_context_decode_gives_the_one_process_tokens(tmp_path):
    cfg = get_smoke(LONG)
    model = build_model(cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(1, LONG_PROMPT))).long()
    with torch.no_grad():
        tokens, k, v = _greedy(model, model.init(model.generator(0)), prompt,
                               NEW, LONG_LEN)
    ranks = run_ranks(RANK, 2, tmp_path, (LONG, 1, "", repr((1, LONG_PROMPT)),
                                          NEW, LONG_LEN))
    assert SHAPES["long_500k"].seq_len >= 262_144
    for r in ranks:
        assert r["rules"]["kv_seq"] == ("pod", "data")
        # half the positions a rank; the prompt reaches the second half
        assert r["local"][2] == LONG_LEN // 2 < LONG_PROMPT
        assert torch.equal(r["tokens"], tokens)
        # a decoded token's K/V come from layers after a partial softmax,
        # whose sums run in another order: within 1e-5 absolute
        np.testing.assert_allclose(r["k"].numpy(), k.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["v"].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5)

"""The port's GraphProfiler on the CPU: the twins of the profiler tests of
``tests/test_profiler_sim.py``, then the example's smoke train step.

The sampled step runs the traced ATen graph through the timed
interpreter; its outputs equal the eager step's within 1e-5 (the same
ops in the same order: in fact bit for bit), and the toy's equal the
JAX package's profiler output on the same inputs within 1e-5 relative.
The example (``examples/diagnose_scaling_loss_torch.py --device cpu``)
recovers its root cause.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GraphProfiler as JaxGraphProfiler
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.core.graph import LOOP
from repro_torch.core.inject import simulate
from repro_torch.core.profiler import GraphProfiler
from repro_torch.core.psg import scan
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, constant
from repro_torch.optim.tree import leaves
from repro_torch.training import TrainState, make_train_step

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _fn(x, w):
    c, _ = scan(lambda c, _: (torch.tanh(c @ w), None), x, range(3),
                name="body")
    return torch.sum(c)


def _jax_fn(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    c, _ = jax.lax.scan(body, x, None, length=3)
    return jnp.sum(c)


def test_profiler_collects_per_vertex_times():
    x, w = torch.ones(16, 32), torch.ones(32, 32)
    prof = GraphProfiler(_fn, (x, w), sample_every=2)
    for _ in range(6):
        prof.step(x, w)
    assert prof.sampled_steps == 3 and len(prof.step_times) == 6
    perf = prof.perf_vectors()
    timed = [v for v in perf.values() if v.samples > 0]
    assert timed, "sampled steps must attribute time to vertices"
    assert all(v.time >= 0 and v.samples == 3 for v in timed)
    # every top-level vertex is timed
    tops = prof.psg.children(prof.psg.root)
    assert {vid for vid, v in perf.items() if v.samples} == set(tops)
    assert any(v.counters.get("flops", 0) > 0 for v in perf.values())


def test_profiler_sampled_output_matches_eager_and_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 16)) / 4).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    prof = GraphProfiler(_fn, (tx, tw), sample_every=1)
    out_sampled = prof.step(tx, tw)          # instrumented path
    np.testing.assert_allclose(out_sampled.numpy(), _fn(tx, tw).numpy(),
                               rtol=1e-5)
    jprof = JaxGraphProfiler(_jax_fn, (jnp.asarray(x), jnp.asarray(w)),
                             sample_every=1)
    np.testing.assert_allclose(out_sampled.numpy(),
                               np.asarray(jprof.step(x, w)), rtol=1e-5)


def test_profiler_seeds_vectorized_base_times():
    x, w = torch.ones(16, 32), torch.ones(32, 32)
    prof = GraphProfiler(_fn, (x, w), sample_every=2)
    for _ in range(6):
        prof.step(x, w)
    base = prof.base_times()
    assert getattr(base, "scalana_vectorized", False)
    res = simulate(prof.psg, 4, base)
    t = res.ppg.times_matrix()
    for vid, vec in prof.perf_vectors().items():
        if vec.samples > 0:
            assert np.allclose(t[:, vid], vec.time)


def test_profiler_storage_far_below_full_trace():
    """Storage is O(graph) while tracing is O(steps x events)."""
    x, w = torch.ones(16, 32), torch.ones(32, 32)
    prof = GraphProfiler(_fn, (x, w), sample_every=2)
    stored_early = None
    for i in range(200):
        prof.step(x, w)
        if i == 9:
            stored_early = prof.storage_bytes()
    assert prof.storage_bytes() < prof.full_trace_bytes() / 10
    assert prof.storage_bytes() <= stored_early * 1.5


def test_profiler_perf_shard_rows():
    x, w = torch.ones(16, 32), torch.ones(32, 32)
    prof = GraphProfiler(_fn, (x, w), sample_every=1)
    prof.step(x, w)
    shard = prof.perf_shard(proc_start=8, n_procs=4)
    assert (shard.proc_start, shard.n_procs) == (8, 4)
    for vid, vec in prof.perf_vectors().items():
        assert np.allclose(shard.time[:, vid], vec.time)


@pytest.fixture(scope="module")
def train_prof():
    cfg = get_smoke("tinyllama-1.1b")
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    state = TrainState(params, adamw_init(params), None,
                       torch.zeros((), dtype=torch.int32))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 65))
    batch = {"tokens": torch.from_numpy(toks)}
    step = make_train_step(model, RunConfig(), constant(1e-3))
    return GraphProfiler(step, (state, batch), sample_every=2), step, \
        state, batch


def test_profiled_train_step_equals_eager(train_prof):
    prof, step, state, batch = train_prof
    s1, m1 = prof.step(state, batch)            # eager
    s2, m2 = prof.step(s1, batch)               # sampled
    e2, em2 = step(s1, batch)                   # eager, same state
    assert list(m2) == list(em2)
    for k in m2:
        np.testing.assert_allclose(m2[k].numpy(), em2[k].numpy(), rtol=1e-5)
    for a, b in zip(leaves(s2.params) + leaves(s2.opt.nu),
                    leaves(e2.params) + leaves(e2.opt.nu)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert int(s2.step) == int(e2.step) == 2
    perf = prof.perf_vectors()
    tops = prof.psg.children(prof.psg.root)
    assert all(perf[v].samples == 1 and perf[v].time >= 0 for v in tops)
    loops = [prof.psg.vertices[v] for v in tops
             if prof.psg.vertices[v].kind == LOOP]
    assert [v.meta["trip_count"] for v in loops] == [2, 4, 4, 2]
    assert prof.overhead_estimate()["sampled_step_s"] > 0


def test_example_recovers_the_root_cause(capsys):
    sys.path.insert(0, EXAMPLES)
    try:
        import diagnose_scaling_loss_torch as example
    finally:
        sys.path.remove(EXAMPLES)
    assert example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "root cause recovered: True" in out
    assert "p17" in out and "scan:layers" in out

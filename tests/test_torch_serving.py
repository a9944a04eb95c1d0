"""The port's serving engine on the CPU against the JAX package's.

Smoke-size models with the JAX parameters carried over by
``params_from_reference``: the reference's five serving tests
(``tests/test_serving.py``) against the port's engine, greedy token
streams equal to the JAX engine's under mixed traffic for the four
families it serves, the port's in-place K/V writes leaving other slots'
cached rows as they were, and the launcher.

Sampled streams are the port's own: its Gumbel noise comes from numpy's
Philox keyed on (seed, uid, position), not from ``jax.random``, so only
their reproducibility is held here (across engines, slots and batching),
never their tokens against the JAX engine's.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import smoke_bundle
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import engine as engine_mod

FAMILIES = ["tinyllama-1.1b", "mamba2-130m", "zamba2-2.7b",
            "moonshot-v1-16b-a3b"]
SRC = Path(__file__).resolve().parent.parent / "src"

_PORT = {}


def _port_bundle(arch):
    """(port bundle on the CPU, the JAX smoke bundle's weights)."""
    if arch not in _PORT:
        _, _, jp = smoke_bundle(arch)
        _PORT[arch] = (build_model(get_smoke(arch), device="cpu"),
                       params_from_reference(jax.tree.map(np.asarray, jp),
                                             device="cpu"))
    return _PORT[arch]


def _engine(arch, slots=3, max_seq=48):
    model, params = _port_bundle(arch)
    return ServingEngine(model, params, batch_slots=slots, max_seq=max_seq)


# -- the reference's five tests (tests/test_serving.py) ----------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_serves_all_requests(arch):
    eng = _engine(arch)
    reqs = [Request(uid=i, prompt=np.arange(1, 5 + i), max_new_tokens=4)
            for i in range(6)]
    results = eng.run(reqs)
    assert [r.uid for r in results] == list(range(6))
    assert all(len(r.tokens) == 4 for r in results)


@pytest.mark.parametrize("arch", FAMILIES)
def test_batching_invariance(arch):
    """Greedy output is identical whether a request runs alone or batched
    with sampled traffic (slot isolation; SSM state hygiene; the in-place
    K/V writes of the other slots)."""
    prompt = np.arange(1, 7)
    alone = _engine(arch, slots=1).run(
        [Request(uid=0, prompt=prompt, max_new_tokens=5)])[0].tokens

    eng = _engine(arch, slots=3)
    traffic = [Request(uid=i, prompt=np.arange(2, 9 + i), max_new_tokens=6,
                       temperature=0.9, seed=i) for i in range(1, 5)]
    mixed = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=5)]
                    + traffic)
    batched = [r for r in mixed if r.uid == 0][0].tokens
    assert batched == alone


def test_temperature_sampling_reproducible():
    eng1 = _engine("tinyllama-1.1b")
    eng2 = _engine("tinyllama-1.1b")
    req = lambda: Request(uid=9, prompt=np.arange(1, 6), max_new_tokens=6,
                          temperature=0.7, seed=123)
    t1 = eng1.run([req()])[0].tokens
    t2 = eng2.run([req()])[0].tokens
    assert t1 == t2


def test_slot_reuse_after_completion():
    eng = _engine("mamba2-130m", slots=2)
    results = eng.run([Request(uid=i, prompt=np.arange(1, 4),
                               max_new_tokens=3) for i in range(5)])
    assert len(results) == 5            # 5 requests through 2 slots
    # same greedy prompt => same tokens regardless of which slot served it
    assert len({tuple(r.tokens) for r in results}) == 1


def test_max_seq_respected():
    eng = _engine("tinyllama-1.1b", slots=1, max_seq=16)
    r = eng.run([Request(uid=0, prompt=np.arange(1, 30),
                         max_new_tokens=40)])[0]
    assert len(r.tokens) <= 40
    assert eng.slot_pos.max() <= 16


# -- against the JAX engine -------------------------------------------------

def _traffic(cfg_vocab, req_cls, n=7, seed=0):
    """Mixed traffic: even uids greedy, odd uids sampled at 0.8."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 12, n)
    return [req_cls(uid=i, prompt=rng.integers(1, cfg_vocab, lens[i]),
                    max_new_tokens=int(rng.integers(3, 8)),
                    temperature=0.0 if i % 2 == 0 else 0.8, seed=i)
            for i in range(n)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_streams_equal_the_jax_engine(arch):
    cfg, jm, jp = smoke_bundle(arch)
    want = JaxEngine(jm, jp, batch_slots=3, max_seq=48).run(
        _traffic(cfg.vocab_size, JaxRequest))
    eng = _engine(arch)
    got = eng.run(_traffic(cfg.vocab_size, Request))
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert len(g.tokens) == len(w.tokens)
        if g.uid % 2 == 0:
            assert g.tokens == w.tokens, g.uid


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b"])
def test_sampled_streams_do_not_depend_on_batching(arch):
    """A sampled request's tokens are keyed on (seed, uid, position) only:
    the same alone, in another slot among other traffic, and on another
    engine instance."""
    cfg = get_smoke(arch)
    req = lambda: Request(uid=3, prompt=np.arange(1, 8), max_new_tokens=6,
                          temperature=0.8, seed=11)
    alone = _engine(arch, slots=1).run([req()])[0].tokens
    traffic = _traffic(cfg.vocab_size, Request, n=3, seed=4)
    for t in traffic:
        t.uid += 10
    mixed = _engine(arch, slots=3).run(traffic + [req()])
    assert [r for r in mixed if r.uid == 3][0].tokens == alone
    assert _engine(arch, slots=3).run([req()])[0].tokens == alone


def test_gumbel_noise_is_keyed_on_seed_uid_and_position():
    a = engine_mod._gumbel(1, 2, 3, 64)
    assert np.array_equal(a, engine_mod._gumbel(1, 2, 3, 64))
    for other in ((1, 2, 4), (1, 3, 3), (2, 2, 3), (-1, 2, 3)):
        assert not np.array_equal(a, engine_mod._gumbel(*other, 64))
    # the next position's draws are not this one's shifted by a few words
    b = engine_mod._gumbel(1, 2, 4, 64)
    assert not any(np.array_equal(a[i:], b[:64 - i]) for i in range(1, 64))


# -- the port's in-place K/V writes -------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b",
                                  "moonshot-v1-16b-a3b"])
def test_prefill_leaves_other_slots_cached_rows_unchanged(arch):
    """Bit for bit: after another slot's prefill, a live slot's K/V rows
    below its length are what they were, though ``decode_step`` wrote
    every row's current position in place."""
    eng = _engine(arch, slots=3)
    eng.submit(Request(uid=0, prompt=np.arange(1, 9), max_new_tokens=8))
    eng.step()
    live = int(eng.slot_pos[0])
    kv = getattr(eng.cache, "kv", eng.cache)
    before_k = kv.k[:, 0, :live].clone()
    before_v = kv.v[:, 0, :live].clone()
    ssm = getattr(eng.cache, "ssm", None)
    before_ssm = None if ssm is None else [s[:, 0].clone() for s in ssm]
    eng.submit(Request(uid=1, prompt=np.arange(3, 15), max_new_tokens=4))
    kv = getattr(eng.cache, "kv", eng.cache)
    assert int(eng.slot_pos[0]) == live
    assert torch.equal(kv.k[:, 0, :live], before_k)
    assert torch.equal(kv.v[:, 0, :live], before_v)
    if before_ssm is not None:           # the hybrid's states: merged back
        for s, b in zip(eng.cache.ssm, before_ssm):
            assert torch.equal(s[:, 0], b)


def test_host_positions_are_copied_into_the_step():
    eng = _engine("tinyllama-1.1b", slots=2)
    eng.slot_pos[:] = [3, 5]
    cache = eng._with_lengths(eng.cache)
    eng.slot_pos[:] = [7, 9]
    assert cache.kv.length.tolist() == [3, 5]


# -- the launcher and the card ------------------------------------------------

def test_launch_serve_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-2.7b", "--device", "cpu", "--requests", "3", "--max-new",
         "4", "--slots", "2"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    assert "[serve] zamba2-2.7b: 3 requests, 12 tokens" in out.stdout


def test_the_engine_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke("tinyllama-1.1b"))

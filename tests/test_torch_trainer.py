"""The port's ``Trainer`` on the CPU, alone and against the JAX package's.

* The twins of the reference's Trainer tests
  (``tests/test_checkpoint_trainer.py``, ``tests/test_elastic.py``):
  training lowers the loss, resume continues from the checkpoint and
  equals an uninterrupted run within 1e-5, gradient accumulation, int8
  error-feedback compression, the ScalAna hooks.
* The JAX ``Trainer`` and the port's from the same initial state (the
  JAX weights carried over by ``params_from_reference``) and the same
  data give per-step losses within 1e-4 relative over 4 steps: plain,
  with two microbatches and with compression.
* Trainer checkpoints cross both ways: one written by the JAX package's
  ``Trainer`` resumes in the port's and one written by the port's resumes
  in the JAX package's, each with the next losses equal to the writer's
  own continuation within 1e-5 relative.
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.training import Trainer as JaxTrainer
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import params_from_reference
from repro_torch.optim import adamw_init
from repro_torch.optim.compress import init_residual
from repro_torch.training import Trainer, TrainState

ARCH = "tinyllama-1.1b"


@pytest.fixture()
def tmpdir(tmp_path):
    return str(tmp_path)


def _run(tmpdir, arch=ARCH, steps=6, **kw):
    run = RunConfig(arch=arch, total_steps=steps, learning_rate=1e-3,
                    warmup_steps=2, checkpoint_dir=tmpdir,
                    checkpoint_every=100, scalana=False, **kw)
    return Trainer(run, arch_cfg=get_smoke(arch),
                   shape=ShapeConfig("smoke", 32, 4, "train"), device="cpu")


def _losses(tr):
    return [m["loss"] for m in tr.metrics_log if "loss" in m]


# ---------------------------------------------------------------------------
# the reference's Trainer tests on the port
# ---------------------------------------------------------------------------

def test_training_reduces_loss(tmpdir):
    tr = _run(tmpdir, steps=8)
    tr.train(num_steps=8)
    losses = _losses(tr)
    assert losses[-1] < losses[0]
    assert all(np.isfinite(l) for l in losses)


def test_resume_continues_from_checkpoint(tmpdir):
    tr = _run(tmpdir, steps=4)
    tr.train(num_steps=4)
    tr2 = _run(tmpdir, steps=4)
    tr2.train(num_steps=4)
    assert tr2.metrics_log[0]["step"] == 4      # resumed, not restarted


def test_resume_bitwise_matches_uninterrupted(tmpdir):
    """Kill-and-restart equals an uninterrupted run (data determinism +
    full state in the checkpoint)."""
    other = tmpdir + "_b"
    tr_once = _run(other, steps=8)
    tr_once.train(num_steps=8)

    tr_a = _run(tmpdir, steps=8)
    tr_a.train(num_steps=4)                     # "crash" after 4
    tr_b = _run(tmpdir, steps=8)
    tr_b.train(num_steps=4)                     # restart, 4 more

    uninterrupted = [m["loss"] for m in tr_once.metrics_log][4:]
    resumed = [m["loss"] for m in tr_b.metrics_log]
    np.testing.assert_allclose(resumed, uninterrupted, rtol=1e-5)
    shutil.rmtree(other, ignore_errors=True)


def test_grad_accumulation_matches_single_batch(tmpdir):
    """microbatch=2 gradient == full-batch gradient (same total step)."""
    t1 = _run(tmpdir + "_1", steps=1)
    t2 = _run(tmpdir + "_2", steps=1, microbatch=2)
    t1.train(num_steps=2, resume=False)
    t2.train(num_steps=2, resume=False)
    np.testing.assert_allclose(_losses(t1), _losses(t2), rtol=2e-3)


def test_grad_compress_trains(tmpdir):
    tr = _run(tmpdir, steps=6, grad_compress=True)
    tr.train(num_steps=6)
    losses = _losses(tr)
    assert losses[-1] < losses[0]
    assert all(np.isfinite(l) for l in losses)


def test_scalana_hooks_collect(tmpdir):
    run = RunConfig(arch=ARCH, total_steps=6, warmup_steps=2,
                    scalana=True, scalana_sample_every=3)
    tr = Trainer(run, arch_cfg=get_smoke(ARCH),
                 shape=ShapeConfig("smoke", 32, 4, "train"), device="cpu")
    tr.train(num_steps=6)
    psg, perf, storage = tr.scalana_artifacts()
    assert psg.stats()["total"] > 5
    assert any(v.samples > 0 for v in perf.values())
    assert 0 < storage < 10 * 2**20      # KBs-to-MBs, not GBs
    assert len(tr.step_wall_times) == 6
    assert tr.profiler.sampled_steps == 2


def test_step_timeout_writes_its_log_entry(tmpdir):
    tr = _run(tmpdir, steps=2)
    tr.train(num_steps=2, step_timeout_s=1e-9)
    assert [m["step"] for m in tr.metrics_log if "timeout" in m] == [0, 1]
    assert tr.state_shardings(tr.init_state()) is None    # no mesh


def test_restart_on_different_topology_is_exact(tmp_path):
    def run(ckpt, steps, num_steps):
        run_cfg = RunConfig(arch=ARCH, total_steps=steps, warmup_steps=2,
                            learning_rate=1e-3, checkpoint_dir=ckpt,
                            checkpoint_every=100, scalana=False)
        tr = Trainer(run_cfg, arch_cfg=get_smoke(ARCH),
                     shape=ShapeConfig("t", 32, 4, "train"), device="cpu")
        tr.train(num_steps=num_steps)
        return [m["loss"] for m in tr.metrics_log]

    a = str(tmp_path / "a")
    once = run(str(tmp_path / "b"), 8, 8)
    run(a, 8, 4)
    resumed = run(a, 8, 4)
    np.testing.assert_allclose(resumed, once[4:], rtol=1e-5)


def test_checkpoint_roundtrip_independent_of_leaf_order(tmp_path):
    tree = {"b": np.ones((3,), np.float32),
            "a": {"x": np.zeros((2, 2), np.float32)}}
    save_checkpoint(str(tmp_path), 1, tree)
    reordered = {"a": {"x": np.full((2, 2), 9.0, np.float32)},
                 "b": np.zeros((3,), np.float32)}
    loaded, _ = load_checkpoint(str(tmp_path), 1, reordered)
    np.testing.assert_array_equal(loaded["b"], np.ones((3,)))
    np.testing.assert_array_equal(loaded["a"]["x"], np.zeros((2, 2)))


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(RunConfig(arch=ARCH), arch_cfg=get_smoke(ARCH),
                shape=ShapeConfig("t", 32, 4, "train"))


# ---------------------------------------------------------------------------
# against the JAX package's Trainer
# ---------------------------------------------------------------------------

RUNS = {"plain": {}, "microbatch2": {"microbatch": 2},
        "compress": {"grad_compress": True}}
SHAPE = (32, 4)                 # seq, global batch


def _common(ckpt, kw):
    return dict(arch=ARCH, total_steps=4, learning_rate=1e-3,
                warmup_steps=2, checkpoint_dir=ckpt, checkpoint_every=100,
                scalana=False, **kw)


def _jax(ckpt="", **kw):
    return JaxTrainer(JaxRunConfig(**_common(ckpt, kw)),
                      arch_cfg=jax_smoke(ARCH),
                      shape=JaxShapeConfig("t", *SHAPE, "train"))


def _port(ckpt="", **kw):
    return Trainer(RunConfig(**_common(ckpt, kw)), arch_cfg=get_smoke(ARCH),
                   shape=ShapeConfig("t", *SHAPE, "train"), device="cpu")


def _port_state(jax_state, compress):
    params = params_from_reference(
        jax.tree.map(np.asarray, jax_state.params), device="cpu")
    return TrainState(params=params, opt=adamw_init(params),
                      residual=init_residual(params) if compress else None,
                      step=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_the_jax_trainer(name):
    jtr, ttr = _jax(**RUNS[name]), _port(**RUNS[name])
    jstate = jtr.init_state()
    state = _port_state(jstate, RUNS[name].get("grad_compress", False))
    jtr.train(num_steps=4, state=jstate, resume=False)
    ttr.train(num_steps=4, state=state, resume=False)
    assert [m["step"] for m in ttr.metrics_log] == [0, 1, 2, 3]
    np.testing.assert_allclose(_losses(ttr), _losses(jtr), rtol=1e-4)


def _manifest_keys(directory, step):
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["leaves"]


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compress"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, compress):
    kw = {"grad_compress": True} if compress else {}
    writer = str(tmp_path / "jax")
    _jax(writer, **kw).train(num_steps=2)               # step_2 written
    shutil.copytree(writer, str(tmp_path / "port"))
    jtr2, ttr = _jax(writer, **kw), _port(str(tmp_path / "port"), **kw)
    jtr2.train(num_steps=2)                             # the writer's own
    ttr.train(num_steps=2)
    assert ttr.metrics_log[0]["step"] == 2
    np.testing.assert_allclose(_losses(ttr), _losses(jtr2), rtol=1e-5)
    # both packages wrote the same manifest keys, shapes and dtypes
    assert _manifest_keys(str(tmp_path / "port"), 4).keys() == \
        _manifest_keys(writer, 4).keys()
    for key, ent in _manifest_keys(writer, 4).items():
        mine = _manifest_keys(str(tmp_path / "port"), 4)[key]
        assert (mine["shape"], mine["dtype"]) == (ent["shape"], ent["dtype"])


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compress"])
def test_port_checkpoint_resumes_in_the_jax_package(tmp_path, compress):
    kw = {"grad_compress": True} if compress else {}
    writer = str(tmp_path / "port")
    _port(writer, **kw).train(num_steps=2)
    keys = _manifest_keys(writer, 2)
    assert ("residual/final_norm" in keys) == compress
    assert {"step", "opt/step"} <= keys.keys()
    shutil.copytree(writer, str(tmp_path / "jax"))
    ttr2, jtr = _port(writer, **kw), _jax(str(tmp_path / "jax"), **kw)
    ttr2.train(num_steps=2)                             # the writer's own
    jtr.train(num_steps=2)
    assert jtr.metrics_log[0]["step"] == 2
    np.testing.assert_allclose(_losses(jtr), _losses(ttr2), rtol=1e-5)

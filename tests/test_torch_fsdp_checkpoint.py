"""Checkpoints of a ``gather_weights`` ``Trainer`` on the CPU.

Four Gloo ranks on a ``("data", "model")`` (2, 2) mesh train the
tinyllama smoke config with FSDP storage: every parameter, moment and
residual leaf whose ``embed`` dim divides the data axis is split on
``data`` as well as on ``model``.  A checkpoint gathers every leaf whole
on both axes before the save and a restore keeps the rank's slice of
both, so:

* 2 steps, a checkpoint, then 2 more from it give the losses of 4
  unbroken steps within 1e-5;
* the last checkpoint restores in one process, and in the JAX package's
  ``Trainer``, leaf for leaf equal to the whole state the ranks gathered.
"""
import os
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.training import Trainer as JaxTrainer
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.training import Trainer
from repro_torch.training.trainer import state_to_tree

from _step_check import run_ranks

ARCH = "tinyllama-1.1b"
SHAPE = (32, 4)                 # seq, global batch

RANK = textwrap.dedent("""
    import os
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.distributed.axes import use_rules
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.optim.tree import leaves
    from repro_torch.training import Trainer
    from repro_torch.training.trainer import state_to_tree, whole_state

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    arch, seq, gb, ckpt = (sys.argv[5], int(sys.argv[6]), int(sys.argv[7]),
                           sys.argv[8])
    init_group(rank, world, "file://" + init, device="cpu", timeout_s=120)
    options = {"gather_weights": True}
    try:
        mesh = make_host_mesh(2, device="cpu")

        def trainer(ckpt):
            run = RunConfig(arch=arch, total_steps=4, learning_rate=1e-3,
                            warmup_steps=2, checkpoint_dir=ckpt,
                            checkpoint_every=100, scalana=False)
            return Trainer(run, mesh=mesh, options=options,
                           arch_cfg=get_smoke(arch),
                           shape=ShapeConfig("t", seq, gb, "train"),
                           device="cpu")

        def losses(tr):
            return [m["loss"] for m in tr.metrics_log if "loss" in m]

        first = trainer(ckpt)
        first.train(num_steps=2)
        second = trainer(ckpt)
        final = second.train(num_steps=2)
        unbroken = trainer("")
        unbroken.train(num_steps=4)
        with use_rules(mesh, None, options):
            whole = state_to_tree(whole_state(final, second.model.specs))
        torch.save({"first": losses(first), "second": losses(second),
                    "resumed_at": second.metrics_log[0]["step"],
                    "unbroken": losses(unbroken), "whole": whole,
                    "local": [tuple(t.shape) for t in leaves(final.params)]},
                   out)
    finally:
        dist.destroy_process_group()
""")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_ckpt")
    ckpt = str(tmp / "ckpt")
    return run_ranks(RANK, 4, tmp, (ARCH, *SHAPE, ckpt)), ckpt


def test_fsdp_trainer_resumes_like_the_unbroken_run(runs):
    ranks, ckpt = runs
    for r in ranks:
        assert r["resumed_at"] == 2
        np.testing.assert_allclose(r["first"] + r["second"], r["unbroken"],
                                   rtol=1e-5)
        # the ranks held quarters of the 2-D weights: split on both axes
        whole = [tuple(v.shape) for k, v in _flat(r["whole"]).items()
                 if k.startswith("params/")]
        assert any(np.prod(a) * 4 == np.prod(b)
                   for a, b in zip(r["local"], whole))
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_4"]


def test_fsdp_checkpoint_restores_in_one_process_and_in_jax(runs):
    ranks, ckpt = runs
    want = _flat(ranks[0]["whole"])
    for r in ranks[1:]:
        assert _flat(r["whole"]).keys() == want.keys()
    one = Trainer(RunConfig(arch=ARCH, total_steps=4, learning_rate=1e-3,
                            warmup_steps=2, checkpoint_dir=ckpt,
                            checkpoint_every=100, scalana=False),
                  arch_cfg=get_smoke(ARCH),
                  shape=ShapeConfig("t", *SHAPE, "train"), device="cpu")
    step, state = one.restore(one.init_state())
    assert step == 4
    got = _flat(state_to_tree(state))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jtr = JaxTrainer(JaxRunConfig(arch=ARCH, total_steps=4,
                                  learning_rate=1e-3, warmup_steps=2,
                                  checkpoint_dir=ckpt, checkpoint_every=100,
                                  scalana=False),
                     arch_cfg=jax_smoke(ARCH),
                     shape=JaxShapeConfig("t", *SHAPE, "train"))
    like = jax.tree.map(np.asarray, jax.device_get(jtr.init_state()))
    jstep, jstate, _ = jtr.ckpt.restore_latest(like)
    assert jstep == 4
    for tag, tree in (("params", jstate.params), ("opt/mu", jstate.opt.mu),
                      ("opt/nu", jstate.opt.nu)):
        flat = _flat(jax.tree.map(np.asarray, tree), tag + "/")
        assert flat.keys() == {k for k in want if k.startswith(tag + "/")}
        for k, v in flat.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)

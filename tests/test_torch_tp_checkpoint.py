"""Checkpoints of the tensor-parallel ``Trainer`` on the CPU.

A checkpoint is the reference's, logically unsharded: under a ``model``
axis every leaf is gathered whole before the save, one rank writes, and
a restore keeps the rank's shards of the whole leaves.  Two Gloo ranks
on a (1, 2) mesh (mamba2-130m smoke, whose SSD heads, embedding and
moments split on ``model``) run, in one set of processes:

* a ``Trainer`` of 2 steps with a checkpoint directory, then one that
  resumes from it for 2 more, and one of 4 steps unbroken;
* a ``Trainer`` that restores a checkpoint written by one process.

The resumed losses equal the unbroken ones within 1e-5; the (1, 2)
checkpoint restores in one process and in the JAX package's ``Trainer``
with the leaves the ranks gathered; the one-process checkpoint restores
under (1, 2) into each rank's shards of it.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.training import Trainer as JaxTrainer
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.distributed import axes as ax
from repro_torch.models.params import _walk
from repro_torch.optim.tree import leaves
from repro_torch.training import Trainer
from repro_torch.training.trainer import state_to_tree

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TIMEOUT_S = 240
ARCH = "mamba2-130m"
SHAPE = (32, 4)                 # seq, global batch


def _run_cfg(ckpt=""):
    return RunConfig(arch=ARCH, total_steps=4, learning_rate=1e-3,
                     warmup_steps=2, checkpoint_dir=ckpt,
                     checkpoint_every=100, scalana=False)


def _port(ckpt=""):
    return Trainer(_run_cfg(ckpt), arch_cfg=get_smoke(ARCH),
                   shape=ShapeConfig("t", *SHAPE, "train"), device="cpu")


RANK = textwrap.dedent("""
    import os
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.mesh import init_group, make_host_mesh
    from repro_torch.optim.tree import leaves
    from repro_torch.training import Trainer
    from repro_torch.training.trainer import state_to_tree, whole_state
    from repro_torch.distributed.axes import use_rules

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    arch, seq, gb, tp_dir, one_dir = (sys.argv[5], int(sys.argv[6]),
                                      int(sys.argv[7]), sys.argv[8],
                                      sys.argv[9])
    init_group(rank, world, "file://" + init, device="cpu", timeout_s=120)
    try:
        mesh = make_host_mesh(2, device="cpu")

        def trainer(ckpt):
            run = RunConfig(arch=arch, total_steps=4, learning_rate=1e-3,
                            warmup_steps=2, checkpoint_dir=ckpt,
                            checkpoint_every=100, scalana=False)
            return Trainer(run, mesh=mesh, arch_cfg=get_smoke(arch),
                           shape=ShapeConfig("t", seq, gb, "train"),
                           device="cpu")

        def losses(tr):
            return [m["loss"] for m in tr.metrics_log if "loss" in m]

        first = trainer(tp_dir)
        first.train(num_steps=2)
        # the other rank has passed the save's barrier: step_2 is committed
        written = sorted(os.listdir(tp_dir))
        second = trainer(tp_dir)
        final = second.train(num_steps=2)
        unbroken = trainer("")
        unbroken.train(num_steps=4)
        with use_rules(mesh):
            whole = state_to_tree(whole_state(final, second.model.specs))
        one = trainer(one_dir)
        got = one.restore(one.init_state())
        res = {"first": losses(first), "second": losses(second),
               "resumed_at": second.metrics_log[0]["step"],
               "unbroken": losses(unbroken), "written": written,
               "whole": whole, "one_step": got[0],
               "one_local": state_to_tree(got[1]),
               "local_shapes": [tuple(t.shape)
                                for t in leaves(final.params)]}
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
""")


def _ranks(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    init = str(tmp_path / "init_2")
    outs = [str(tmp_path / f"rank{r}_of_2.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), "2", init,
                               outs[r], *map(str, args)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
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
def runs(tmp_path_factory):
    """The ranks' results, the (1, 2) checkpoint directory, and the
    one-process trainer that wrote the checkpoint they restore."""
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    tp_dir, one_dir = str(tmp / "tp"), str(tmp / "one")
    writer = _port(one_dir)
    writer.train(num_steps=2)
    ranks = _ranks(tmp, ARCH, *SHAPE, tp_dir, one_dir)
    return ranks, tp_dir, one_dir


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def test_tensor_parallel_trainer_resumes_like_the_unbroken_run(runs):
    """2 steps, a checkpoint, 2 more from it: the unbroken 4 steps'
    losses within 1e-5 on each rank; one rank wrote step_2 and the
    other found it committed after the save's barrier."""
    ranks, tp_dir, _ = runs
    for r in ranks:
        assert r["written"] == ["step_2"]
        assert r["resumed_at"] == 2
        np.testing.assert_allclose(r["first"] + r["second"], r["unbroken"],
                                   rtol=1e-5)
        # the ranks held shards: the checkpoint's leaves are whole
        whole = [tuple(v.shape) for k, v in _flat(r["whole"]).items()
                 if k.startswith("params/")]
        assert any(a != b for a, b in zip(r["local_shapes"], whole))
    assert sorted(os.listdir(tp_dir)) == ["step_2", "step_4"]


def test_tensor_parallel_checkpoint_restores_in_one_process_and_in_jax(runs):
    """The (1, 2) run's last checkpoint (step 4) is the ranks' whole
    state: one process of the port restores it leaf for leaf, and so does
    the JAX package's ``Trainer`` (the store is byte-compatible)."""
    ranks, tp_dir, _ = runs
    want = _flat(ranks[0]["whole"])
    assert _flat(ranks[1]["whole"]).keys() == want.keys()
    one = _port(tp_dir)
    step, state = one.restore(one.init_state())
    assert step == 4
    got = _flat(state_to_tree(state))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jtr = JaxTrainer(JaxRunConfig(arch=ARCH, total_steps=4,
                                  learning_rate=1e-3, warmup_steps=2,
                                  checkpoint_dir=tp_dir,
                                  checkpoint_every=100, scalana=False),
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


def test_one_process_checkpoint_restores_into_the_rank_shards(runs):
    """A checkpoint written by one process (step 2) restores under (1, 2):
    each rank holds its own slice of every whole leaf that splits on
    ``model`` and the whole leaf of the others."""
    ranks, _, one_dir = runs
    one = _port(one_dir)
    step, state = one.restore(one.init_state())
    assert step == 2
    whole = state_to_tree(state)
    specs = dict(("/".join(p), s) for p, s in _walk(one.model.specs))
    split = 0
    for rank, r in enumerate(ranks):
        assert r["one_step"] == 2
        got = _flat(r["one_local"])
        assert got.keys() == _flat(whole).keys()
        for k, v in _flat(whole).items():
            name = k.split("/", 2)[-1] if k.startswith("opt/") else \
                k.split("/", 1)[-1]
            sp = specs.get(name)
            want = v
            if sp is not None and k != "opt/step":
                with ax.use_rules({"data": 1, "model": 2}):
                    want = ax.local_shard(torch.from_numpy(v), sp.axes,
                                          rank=rank).numpy()
                split += want.shape != v.shape
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert split > 0

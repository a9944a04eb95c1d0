"""Holding a first AdamW step (from zero moments) against a reference
step on the same weights and batch.

AdamW's first step moves an element by ``lr * g / (|g| + eps)``, whose
slope in ``g`` is up to ``1 / eps``: where a gradient is near ``eps``
(1e-8), a round-off difference of the gradient (a sum taken in another
order) moves the new parameter by up to ``lr / eps`` times that.  So the
new parameters are not held against the reference's directly.  The check
is split instead:

* the first moments (``(1 - b1) g``) equal the reference's within 1e-5
  relative (1e-6 absolute), and the second moments hold the same
  gradient (``sqrt(nu / (1 - b2))`` within 1e-5 relative and absolute
  of the reference's ``|g|``);
* the new parameters are AdamW's first step from the old parameters and
  the step's own moments, recomputed here, within 1e-6 relative (1e-5
  of lr absolute): a wrong learning rate or a dropped weight decay on a
  shard fails here.

``run_ranks`` runs a script as CPU ranks of one Gloo process group (the
multi-rank tests' harness).
"""
import numpy as np
import torch

# the steps' AdamW: ``adamw_update``'s defaults, ``RunConfig``'s decay
LR, B1, B2, EPS, WD = 1e-3, 0.9, 0.95, 1e-8, 0.1


def first_step(old, mu, nu, *, lr=LR):
    """AdamW's first step from ``old`` given the moments it left, in
    float32 as ``repro_torch.optim.adamw_update`` computes it."""
    bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32)
    bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32)
    old = old.float()
    delta = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + EPS)
    return old - lr * (delta + WD * old)


def assert_first_step_close(got_params, got_mu, got_nu, old_params, mu, *,
                            lr=LR):
    """``got_*``: the step's new parameters and moments; ``old_params``
    the parameters it started from; ``mu`` the reference's first
    moments."""
    n = len(mu)
    assert len(got_params) == len(got_mu) == len(got_nu) == n
    assert len(old_params) == n
    for a, b in zip(got_mu, mu):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg="mu")
    for v, b in zip(got_nu, mu):
        np.testing.assert_allclose(np.sqrt(v.double().numpy() / (1 - B2)),
                                   b.double().abs().numpy() / (1 - B1),
                                   rtol=1e-5, atol=1e-5, err_msg="nu")
    for p, p0, m, v in zip(got_params, old_params, got_mu, got_nu):
        np.testing.assert_allclose(p.numpy(),
                                   first_step(p0, m, v, lr=lr).numpy(),
                                   rtol=1e-6, atol=1e-5 * lr,
                                   err_msg="params")


def run_ranks(body, world, tmp_path, args=(), timeout_s=240):
    """Run the script ``body`` as ``world`` CPU ranks (``python -c body
    rank world init out *args``, rendezvous through a file in
    ``tmp_path``); each rank's result, which it saves to ``out`` with
    ``torch.save``."""
    import os
    import subprocess
    import sys
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    init = str(tmp_path / f"init_{world}")
    outs = [str(tmp_path / f"rank{r}_of_{world}.pt") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", body, str(r),
                               str(world), init, outs[r], *map(str, args)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(o, weights_only=False) for o in outs]

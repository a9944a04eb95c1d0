"""FSDP storage (``gather_weights``) and sequence parallelism
(``seq_shard``) for the SSM, hybrid and encoder-decoder families on the
CPU, against the one-process step.

Four Gloo ranks on a ``("data", "model")`` (2, 2) mesh run the smoke
configs of mamba2, zamba2 and seamless-m4t under each option and both,
as ``tests/test_torch_fsdp_sp.py`` runs the transformer families: the SSD
blocks gather the residual stream's seq slices before their projections
(the conv and scan see the whole sequence of the rank's heads), zamba2's
shared block sits in the Branch arm on the same slices, and seamless
splits its encoder's 16 frames and its decoder's 16 positions alike,
gathering the encoder's output once for the cross-attention.  Each step
matches the one-process step as ``_step_check`` holds it, and the
parameters and moments are stored as ``gather_weights`` splits them.
"""
import json

import numpy as np
import pytest

from test_torch_fsdp_sp import OPTS, RANK, check_step, one_process, storage

from _step_check import run_ranks

ARCHS = ("mamba2-130m", "zamba2-2.7b", "seamless-m4t-medium")
CASES = [(a, o) for a in ARCHS for o in OPTS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(RANK, 4, tmp_path_factory.mktemp("fsdp_ssm"),
                     (1, 2, json.dumps(CASES), json.dumps(None)))


@pytest.mark.parametrize("arch,opts", CASES,
                         ids=[f"{a}-{o}" for a, o in CASES])
def test_step_equals_the_one_process_step(runs, arch, opts):
    want = one_process(arch)
    split, local = storage(want["specs"], {"data": 2, "model": 2}, opts)
    _, base = storage(want["specs"], {"data": 2, "model": 2}, "")
    assert any(split) == ("gw" in opts)
    for rank in runs:
        r = rank[f"{arch}:{opts}"]
        check_step(r, want)
        assert r["local"] == r["mu_local"] == local
        for spl, loc, b in zip(split, local, base):
            assert np.prod(loc) * (2 if spl else 1) == np.prod(b)

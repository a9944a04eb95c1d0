"""Sequence parallelism on the 16x16 mesh: the transformer families.

As ``tests/test_torch_cells_16x16.py`` (one rank of a fake group,
published widths, two blocks), one train and one prefill cell of the
dense, MoE and VLM families on the 16x16 mesh under ``seq_shard``: the
residual stream between blocks is the rank's slice of the sequence over
the 16-way model axis.
"""
import pytest

from repro_torch.core.graph import COMM
from repro_torch.distributed import axes as ax
from repro_torch.optim.tree import leaves

from test_torch_cells_16x16 import production, trace

ARCHS = ('tinyllama-1.1b', 'moonshot-v1-16b-a3b', 'internvl2-2b')
CELLS = [(a, s) for a in ARCHS for s in ("train_4k", "prefill_32k")]


@pytest.fixture(scope="module")
def mesh():
    yield from production(False)


def _groups(psg, kind):
    return [v.meta["replica_groups"][0] for v in psg.by_kind(COMM)
            if v.comm_kind == kind]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_builds_and_traces(mesh, arch, shape):
    cell, psg, _ = trace(mesh, arch, shape, {'seq_shard': True})
    # the residual stream split on seq over the model axis (16
    # consecutive ranks): gathered at each block's entry, reduce-scattered
    # at its exit
    assert cell.rules["res_seq"] == "model"
    for kind in ("all_gather", "reduce_scatter"):
        assert [g for g in _groups(psg, kind)
                if len(g) == 16 and g[1] - g[0] == 1], kind

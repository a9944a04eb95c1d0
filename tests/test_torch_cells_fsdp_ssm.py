"""FSDP storage on the 2x16x16 mesh: the SSM, hybrid and encoder-decoder
families.

As ``tests/test_torch_cells_16x16.py`` (one rank of a fake group,
published widths, two blocks), one train and one prefill cell of the
SSM, hybrid and encoder-decoder families on the 2x16x16 mesh under
``gather_weights``: a rank stores the ``data`` part of each parameter's
spec (its ``embed`` dim over 16 ranks) and gathers it at use.
"""
import pytest

from repro_torch.core.graph import COMM
from repro_torch.distributed import axes as ax
from repro_torch.optim.tree import leaves

from test_torch_cells_16x16 import production, trace

ARCHS = ('mamba2-130m', 'zamba2-2.7b', 'seamless-m4t-medium')
CELLS = [(a, s) for a in ARCHS for s in ("train_4k", "prefill_32k")]


@pytest.fixture(scope="module")
def mesh():
    yield from production(True)


def _groups(psg, kind):
    return [v.meta["replica_groups"][0] for v in psg.by_kind(COMM)
            if v.comm_kind == kind]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_builds_and_traces(mesh, arch, shape):
    cell, psg, _ = trace(mesh, arch, shape, {'gather_weights': True})
    # a rank stores the data part of the specs: the embedding's embed
    # dim split 16 ways (and the model part: its vocab rows)
    params = cell.args[0].params if cell.kind == "train" else cell.args[0]
    cfg = cell.model.cfg
    emb = params["embed"]["embedding"]
    assert emb.shape[1] == cfg.d_model // 16
    n = sum(t.numel() for t in leaves(params))
    with ax.use_rules(cell.mesh, cell.rules):
        base = sum(t.numel() for t in leaves(cell.model.abstract_params()))
    assert n < base / 8
    # gathered at use over the data axis (16 ranks, 16 apart), and in
    # the train step's backward reduce-scattered there
    data = [g for g in _groups(psg, "all_gather")
            if len(g) == 16 and g[1] - g[0] == 16]
    assert data
    if cell.kind == "train":
        assert [g for g in _groups(psg, "reduce_scatter")
                if len(g) == 16 and g[1] - g[0] == 16]

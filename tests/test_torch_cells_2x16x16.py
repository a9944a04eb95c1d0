"""The production-mesh cells that need the sequence-split cache or the
pod axis, traced on the 2x16x16 ``("pod", "data", "model")`` mesh.

As ``tests/test_torch_cells_16x16.py`` (one rank of a 512-rank fake
group, published widths, two blocks): the GQA fallback's prefill and
decode cells and ``long_500k`` (the cache's positions on pod and data: a
thirty-second a rank), and every cell of the MoE models on this mesh:
their load-balance means all-reduce over the flattened pod-and-data
group, which the mesh's installation makes outside the trace, as does
the train step's gradient bucket.
"""
import pytest

from repro_torch.core.graph import COMM

from test_torch_cells_16x16 import (CELLS, check_split_cache, production,
                                    trace)

MOE = [("moonshot-v1-16b-a3b", s) for s in ("train_4k", "prefill_32k",
                                            "decode_32k")] + [
    ("dbrx-132b", "train_4k")]


@pytest.fixture(scope="module")
def mesh():
    yield from production(True)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_builds_and_traces(mesh, arch, shape):
    cell, _, _ = trace(mesh, arch, shape)
    if shape == "long_500k":
        assert cell.rules["kv_seq"] == ("pod", "data")
        check_split_cache(cell, 32)
    else:
        assert cell.rules["kv_seq"] == "model"
        check_split_cache(cell, 16)


@pytest.mark.parametrize("arch,shape", MOE, ids=[f"{a}-{s}" for a, s in MOE])
def test_moe_cell_means_over_pod_and_data(mesh, arch, shape):
    cell, psg, _ = trace(mesh, arch, shape)
    groups = [v.meta["replica_groups"][0] for v in psg.by_kind(COMM)
              if v.comm_kind == "all_reduce"]
    batch = [g for g in groups if len(g) == 32]
    assert batch, groups
    # pod-major: the rank's data line in each pod, 256 ranks apart
    assert all(g[16] - g[0] == 256 for g in batch)

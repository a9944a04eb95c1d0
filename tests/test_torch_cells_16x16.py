"""The production-mesh cells that need the sequence-split cache, traced
on the 16x16 ``("data", "model")`` mesh.

One rank of a 256-rank fake process group (``fake_process_group``:
collectives are recorded, nothing moves) builds and traces
``build_cell(...).lower()`` for each config at its published widths and
two blocks deep:

* prefill and decode of the GQA models whose KV heads do not divide the
  16-way model axis (nemotron, yi, tinyllama, internvl2, dbrx): the rules
  put the cache's positions on ``model``, so a rank's cache holds a
  sixteenth of them and every KV head;
* ``long_500k`` for zamba2 (the cache's positions on the batch axes, a
  sixteenth a rank) and mamba2 (no attention cache: nothing to split).

``tools_torch/cells_sweep.py`` traces every applicable cell of both
meshes under every option set; these files hold the cells that the
sequence-split cache, the pod axis and the two options made build.
"""
import time

import pytest

from repro_torch.configs import SHAPES, get
from repro_torch.core.graph import COMM
from repro_torch.distributed import axes as ax
from repro_torch.launch import shardings
from repro_torch.launch.mesh import fake_process_group, make_production_mesh

GQA = ("nemotron-4-15b", "yi-6b", "tinyllama-1.1b", "internvl2-2b",
       "dbrx-132b")
LAYERS = 2
RANK = 37                        # off coordinate 0 of every axis


def cut(arch, layers=LAYERS):
    cfg = get(arch)
    over = {"n_layers": min(cfg.n_layers, layers)}
    if cfg.enc_layers:
        over["enc_layers"] = min(cfg.enc_layers, layers)
    return cfg.replace(**over)


def production(multi_pod):
    """A fixture body: the production mesh for a rank of a fake group."""
    with fake_process_group(512 if multi_pod else 256, rank=RANK):
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")


def trace(mesh, arch, shape, options=None, layers=LAYERS):
    """(cell, its traced PSG, seconds) of one cell."""
    t0 = time.perf_counter()
    cell = shardings.build_cell(arch, shape, mesh, cfg=cut(arch, layers),
                                options=options)
    psg = cell.lower().psg
    assert psg.by_kind(COMM)
    return cell, psg, time.perf_counter() - t0


def cache_positions(cell):
    """The positions of the rank's decode cache (None without attention)."""
    cache = cell.args[1]
    kv = getattr(cache, "kv", None) or getattr(cache, "self_kv", None)
    if kv is not None:
        return kv.k.shape[2]
    return cache.k.shape[2] if hasattr(cache, "k") else None


def check_split_cache(cell, parts):
    """The cell's cache, prefill's or decode's, holds 1/parts of the
    positions of a rank (decode: in its arguments)."""
    sizes = ax.axis_sizes(cell.mesh)
    axes = ax._mesh_axes_of(cell.rules["kv_seq"], sizes)
    n = 1
    for a in axes:
        n *= sizes[a]
    assert n == parts
    if cell.kind == "decode" and cache_positions(cell) is not None:
        assert cache_positions(cell) == cell.shape.seq_len // parts


@pytest.fixture(scope="module")
def mesh():
    yield from production(False)


CELLS = [(a, s) for a in GQA for s in ("prefill_32k", "decode_32k")] + [
    ("zamba2-2.7b", "long_500k"), ("mamba2-130m", "long_500k")]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_builds_and_traces(mesh, arch, shape):
    cell, psg, _ = trace(mesh, arch, shape)
    if shape == "long_500k":
        assert cell.rules["kv_seq"] == ("pod", "data")
        check_split_cache(cell, 16)
        if arch == "mamba2-130m":
            assert cache_positions(cell) is None
    else:
        assert (cell.rules["kv_seq"], cell.rules["kv_heads"]) == ("model",
                                                                  None)
        check_split_cache(cell, 16)
        assert cell.model.cfg.n_kv_heads % 16

"""The port's cost walk over a traced FX graph (``core/fx_walk.py``)
against the JAX package's HLO walk, ``FlopCounterMode`` and shapes.

* The nine smoke cells of ``tests/test_launch.py`` (tinyllama, mamba2,
  moonshot x train / prefill / decode) on a 1x1 mesh: the walk's
  ``dot_flops`` within 5% of the JAX package's
  ``analyze_hlo(...).dot_flops``; ``argument_bytes`` equal to the JAX
  package's ``memory_analysis().argument_size_in_bytes`` but for the
  token ids, which are int64 in the port (torch's index dtype) and int32
  in the reference: 4 bytes a token; ``dot_flops`` equal to
  ``torch.utils.flop_counter.FlopCounterMode``'s matrix products over
  the same step run eagerly on the CPU, and ``argument_bytes`` to the
  bytes of those real inputs.
* The collectives of tinyllama's smoke train cell on a fake (1, 2) mesh
  by kind, in result bytes, against a count worked out from the shapes.
* A decode cell's cache write counts its region, not the cache.
* The dry run's two-depth extrapolation equals a full trace of a 4-layer
  smoke config for every family: FLOPs, bytes and collectives exact.
"""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShape
from repro.core.hlo_walk import analyze_hlo
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.shardings import build_cell as jax_build_cell
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import fx_walk
from repro_torch.core.psg import _flatten
from repro_torch.launch import dryrun, shardings
from repro_torch.launch.mesh import fake_process_group, make_host_mesh

NAMES = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
MATMULS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
           torch.ops.aten.baddbmm)


def _port_cell(arch, kind, mesh, seq=32, batch=2, cfg=None):
    cfg = cfg if cfg is not None else get_smoke(arch)
    return shardings.build_cell(arch, NAMES[kind], mesh, cfg=cfg,
                                shape=ShapeConfig(NAMES[kind], seq, batch,
                                                  kind))


def _jax_cost(arch, kind, monkeypatch):
    shape = JaxShape("t", 32, 2, kind)
    monkeypatch.setitem(JAX_SHAPES, shape.name, shape)
    cell = jax_build_cell(arch, shape.name, jax_host_mesh(),
                          cfg=jax_smoke(arch), donate=False)
    compiled = cell.lower().compile()
    return (analyze_hlo(compiled.as_text()),
            compiled.memory_analysis().argument_size_in_bytes)


def _matmul_flops(counter: FlopCounterMode) -> int:
    table = counter.get_flop_counts()["Global"]
    return sum(n for op, n in table.items() if op in MATMULS)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_walk_matches_hlo_walk_and_flop_counter(arch, kind, monkeypatch):
    hlo, jax_args = _jax_cost(arch, kind, monkeypatch)
    with fake_process_group(1):
        mesh = make_host_mesh(1, device="cpu")
        cell = _port_cell(arch, kind, mesh)
        cost = fx_walk.walk(cell.lower().graph_module)
        real = cell.materialize("cpu", seed=0)
        with FlopCounterMode(display=False) as counter:
            cell.run(*real)
    assert cost.dot_flops == pytest.approx(hlo.dot_flops, rel=0.05)
    tokens = cell.args[2] if kind == "decode" else cell.args[1]["tokens"]
    assert tokens.dtype == torch.int64
    assert cost.argument_bytes == jax_args + 4 * tokens.numel()
    assert cost.argument_bytes == sum(
        t.untyped_storage().nbytes() for t in _flatten(real)[0])
    assert cost.dot_flops == _matmul_flops(counter)


def test_collective_result_bytes_from_shapes():
    """tinyllama's smoke train step on a fake (1, 2) ("data", "model")
    mesh gathers nothing: every collective is an all-reduce, whose result
    bytes equal its input's."""
    cfg = get_smoke("tinyllama-1.1b").replace(remat=False)
    B, S = 2, 32
    with fake_process_group(2):
        mesh = make_host_mesh(2, device="cpu")
        cell = _port_cell("tinyllama-1.1b", "train", mesh, S, B, cfg)
        cost = fx_walk.walk(cell.lower().graph_module)
        local = sum(t.numel() for t in _flatten(cell.args[0].params)[0])
    L, D = cfg.n_layers, cfg.d_model
    act = B * S * D * 2                       # (B, S, D) bf16 activations
    # forward: the vocab-split embedding and two row-parallel outputs a
    # layer; backward: the column-parallel inputs' gradients as many
    n_act = 2 * (1 + 2 * L)
    # the vocab-split loss: max, sum of exps and the target's logit over
    # model a (B, loss_chunk) chunk in float32
    n_chunk = 3 * (S // cfg.loss_chunk)
    chunk = B * cfg.loss_chunk * 4
    bucket = 4 * (local + 1)                  # gradients + loss over data
    norms = 2 * 4                             # AdamW's two squared norms
    assert cost.coll_counts == {"all-reduce": n_act + n_chunk + 1 + 2}
    assert cost.coll_bytes == {
        "all-reduce": n_act * act + n_chunk * chunk + bucket + norms}
    assert cost.total_coll_bytes == cost.coll_bytes["all-reduce"]
    # every group lies inside one 8-card node; the bucket's is {0}
    assert all(c.intra_node for c in cost.collectives)
    assert sorted({tuple(c.group) for c in cost.collectives}) == \
        [(0,), (0, 1)]
    for c in cost.collectives:                # result = input (all-reduce)
        assert c.result_bytes == c.input_bytes


def test_decode_cache_write_counts_its_region():
    """The in-place ``cache[rows, slot] = ...`` moves the written rows,
    not the cache: its traffic does not grow with the cache."""
    writes = {}
    for seq in (32, 1024):
        with fake_process_group(1):
            mesh = make_host_mesh(1, device="cpu")
            cell = _port_cell("tinyllama-1.1b", "decode", mesh, seq=seq)
            gm = cell.lower().graph_module
        cache = cell.args[1].kv.k
        layer = cache[0].numel() * cache.element_size()
        nodes = [n for n in gm.graph.nodes
                 if n.op == "call_function"
                 and fx_walk.costs.op_name(n) in fx_walk.REGION_OPS]
        assert nodes
        moved = []
        for n in nodes:
            name = fx_walk.costs.op_name(n)
            src = n.args[fx_walk._REGION_SRC[name]].meta["val"]
            got = fx_walk._traffic(n, name, [n.meta["val"]], False)
            region = src.numel() * src.element_size()
            assert got == 2 * region + fx_walk._arg_bytes(n, skip=(
                0, fx_walk._REGION_SRC[name]))
            assert got < layer
            moved.append(got)
        writes[seq] = moved
    assert writes[32] == writes[1024]


FAMILIES = [("tinyllama-1.1b", "train"), ("moonshot-v1-16b-a3b", "train"),
            ("mamba2-130m", "train"), ("zamba2-2.7b", "train"),
            ("zamba2-2.7b", "decode"), ("seamless-m4t-medium", "train"),
            ("seamless-m4t-medium", "decode"), ("internvl2-2b", "train")]


@pytest.mark.parametrize("arch,kind", FAMILIES)
def test_depth_extrapolation_equals_a_full_trace(arch, kind):
    cfg = get_smoke(arch).replace(n_layers=4, remat=False)
    if cfg.enc_layers:
        cfg = cfg.replace(enc_layers=3)
    shape = ShapeConfig(NAMES[kind], 16, 4, kind)
    with fake_process_group(4):
        mesh = make_host_mesh(2, device="cpu")
        got, depth, _ = dryrun.trace_cost(arch, NAMES[kind], mesh, {},
                                          cfg=cfg, shape=shape)
        want, whole, _ = dryrun.trace_cost(arch, NAMES[kind], mesh, {},
                                           layers=4, cfg=cfg, shape=shape)
    assert depth["extrapolated_to"] == whole["traced"][0]
    assert len(depth["traced"]) == (3 if cfg.enc_layers or cfg.attn_every
                                    else 2)
    exact = [k for k in want if k.startswith(("bytes:", "count:"))] + [
        "dot_flops", "mem_bytes", "xla_flops_raw", "argument_bytes",
        "output_bytes", "nvlink_bytes", "ib_bytes"]
    assert any(k.startswith("bytes:") for k in want)
    for k in exact:
        assert got[k] == want[k], k
    assert got["temp_bytes"] == pytest.approx(want["temp_bytes"], rel=0.25)
    assert math.isclose(dryrun.roofline(got)["compute_s"],
                        dryrun.roofline(want)["compute_s"])

"""The port's PSG builder and contraction on the CPU.

The example's smoke tinyllama train step (tokens (4, 65), the JAX
package's weights) through both packages: the contracted PSG's
top-level Loop vertices in order with their trip counts (forward layer
scan, loss-chunk scan, its backward, backward layer scan), the matmul
FLOPs rolled up into each and over the whole step against the JAX PSG's
``dot_general`` FLOPs (within 1%; they are the same products, so in
fact equal), and a ``file:line`` under ``src/repro_torch/`` on every
vertex.  The same at a sequence that leaves a loss-chunk remainder
(which belongs to no loop) and with ``remat`` off (the backward loops
then come without a recompute).  The zamba2 smoke step (tokens (2, 65), remat
on and off) has the JAX PSG's Branch vertices: the shared block's
``psg.cond`` nested in the forward layer Loop, and in the backward one
(the transposed cond, and with remat the recompute's).  Then the twins
of ``tests/test_psg.py`` on a toy scan and a toy cond, and its
contraction property test on the port's copy of ``contract``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import RunConfig as JaxRunConfig
from repro.core import build_psg as jax_build_psg
from repro.core import contract as jax_contract
from repro.models.api import build_model as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.schedule import constant as jax_constant
from repro.training.trainer import TrainState as JaxTrainState
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_reference
from repro_torch.core import costs
from repro_torch.core.contraction import contract
from repro_torch.core.graph import BRANCH, COMM, COMP, LOOP, PSG
from repro_torch.core.psg import (build_psg, cond, scan, top_level_order,
                                  trace)
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, constant
from repro_torch.training import TrainState, make_train_step

ARCH = "tinyllama-1.1b"
MATMULS = ("mm", "bmm", "addmm", "baddbmm")
PORT_SRC = os.sep.join(("src", "repro_torch", ""))
LOOPS = ["scan:layers", "scan:loss_chunks", "scan:loss_chunks.grad",
         "scan:layers.grad"]


@pytest.fixture(scope="module")
def weights():
    jm = jax_build(jax_smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _jax_psg(weights, seq, remat=True, arch=ARCH, batch=4):
    _, jp, _ = weights
    jm = jax_build(jax_smoke(arch).replace(remat=remat))
    state = JaxTrainState(params=jp, opt=jax_adamw_init(jp), residual=None,
                          step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(jm, JaxRunConfig(), jax_constant(1e-3))
    return jax_build_psg(step, state, {"tokens": jnp.ones((batch, seq),
                                                          jnp.int32)})


def _port_psg(weights, seq, remat=True, arch=ARCH, batch=4):
    _, _, tp = weights
    model = build_model(get_smoke(arch).replace(remat=remat), device="cpu")
    state = TrainState(tp, adamw_init(tp), None,
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, RunConfig(), constant(1e-3))
    return build_psg(step, state, {"tokens": torch.ones((batch, seq),
                                                        dtype=torch.long)})


def _matmul_flops(g, vid, names):
    """Matmul FLOPs under ``vid``: a loop's body times its trip count."""
    v = g.vertices[vid]
    kids = g.children(vid)
    if not kids:
        return v.flops if v.name in names else 0.0
    trips = v.meta.get("trip_count", 1) if v.kind == LOOP else 1
    return trips * sum(_matmul_flops(g, k, names) for k in kids)


def _loops(g):
    c, _ = contract(g, 10)
    return [(v.name, v.meta["trip_count"]) for v in c.vertices
            if v.parent == c.root and v.kind == LOOP]


@pytest.mark.parametrize("seq,remat", [(65, True), (71, True), (65, False)],
                         ids=["example", "remainder", "noremat"])
def test_step_psg_matches_jax(weights, seq, remat):
    jg = _jax_psg(weights, seq, remat)
    tg = _port_psg(weights, seq, remat)
    jloops, tloops = _loops(jg), _loops(tg)
    assert [t for _, t in jloops] == [t for _, t in tloops] == [2, 4, 4, 2]
    assert [n for n, _ in tloops] == LOOPS
    jtop = [v for v in top_level_order(jg) if jg.vertices[v].kind == LOOP]
    ttop = [v for v in top_level_order(tg) if tg.vertices[v].kind == LOOP]
    for jv, tv in zip(jtop, ttop):
        want = _matmul_flops(jg, jv, ("dot_general",))
        assert want > 0
        assert _matmul_flops(tg, tv, MATMULS) == pytest.approx(want, rel=1e-2)
    want = sum(_matmul_flops(jg, v, ("dot_general",))
               for v in top_level_order(jg))
    got = sum(_matmul_flops(tg, v, MATMULS) for v in top_level_order(tg))
    assert got == pytest.approx(want, rel=1e-2)
    for v in tg.vertices:
        if v.vid != tg.root:
            path, _, line = v.source.rpartition(":")
            assert PORT_SRC in path and int(line) > 0, (v.name, v.source)


def test_step_psg_loops_name_their_source(weights):
    tg = _port_psg(weights, 65)
    c, _ = contract(tg, 10)
    srcs = [v.source for v in c.vertices
            if v.parent == c.root and v.kind == LOOP]
    assert [os.path.basename(s.rpartition(":")[0]) for s in srcs] == \
        ["transformer.py", "layers.py", "layers.py", "transformer.py"]
    assert srcs[0] == srcs[3] and srcs[1] == srcs[2]   # forward = backward


HYBRID = "zamba2-2.7b"


@pytest.fixture(scope="module")
def hybrid_weights():
    jm = jax_build(jax_smoke(HYBRID))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _descendants(g, vid):
    out, todo = [], list(g.children(vid))
    while todo:
        k = todo.pop()
        out.append(k)
        todo.extend(g.children(k))
    return out


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
def test_hybrid_step_psg_has_the_jax_branches(hybrid_weights, remat):
    """zamba2's shared block through ``psg.cond``: with remat the JAX PSG
    has 3 Branch vertices (the forward cond in the layer scan; in the
    backward scan the recompute's and the transposed cond), 2 without.
    The port's loop counters sum the real iterations (2 of the 4 run the
    block), so the quantity compared is trip x body, the body being
    iteration 0, which takes the block, as the JAX rollup counts it."""
    jg = _jax_psg(hybrid_weights, 65, remat, HYBRID, batch=2)
    tg = _port_psg(hybrid_weights, 65, remat, HYBRID, batch=2)
    jb, tb = jg.by_kind(BRANCH), tg.by_kind(BRANCH)
    assert len(tb) == len(jb) == (3 if remat else 2)
    tloops = [v for v in top_level_order(tg) if tg.vertices[v].kind == LOOP]
    jloops = [v for v in top_level_order(jg) if jg.vertices[v].kind == LOOP]
    assert [tg.vertices[v].meta["trip_count"] for v in tloops] == \
        [jg.vertices[v].meta["trip_count"] for v in jloops] == [4, 4, 4, 4]
    for tv, jv in zip(tloops, jloops):
        want = _matmul_flops(jg, jv, ("dot_general",))
        assert want > 0
        assert _matmul_flops(tg, tv, MATMULS) == pytest.approx(want, rel=1e-2)
    fwd, bwd = (next(tg.vertices[v] for v in tloops
                     if tg.vertices[v].name == n)
                for n in ("scan:layers", "scan:layers.grad"))
    (tfb,) = [k for k in tg.children(fwd.vid)
              if tg.vertices[k].kind == BRANCH]
    path, _, line = tg.vertices[tfb].source.rpartition(":")
    assert path.endswith(os.path.join("repro_torch", "models", "hybrid.py"))
    assert int(line) > 0
    assert any(tg.vertices[k].kind == BRANCH
               for k in _descendants(tg, bwd.vid))
    (jfb,) = [k for k in jg.children(jloops[0])
              if jg.vertices[k].kind == BRANCH]
    assert _matmul_flops(tg, tfb, MATMULS) == pytest.approx(
        _matmul_flops(jg, jfb, ("dot_general",)), rel=1e-2)


# ---------------------------------------------------------------------------
# the twins of tests/test_psg.py on a toy scan
# ---------------------------------------------------------------------------

def _example_fn(x, w):
    c, _ = scan(lambda c, _: (torch.tanh(c @ w), None), x, range(4),
                name="body")
    return torch.where(torch.sum(c) > 0, torch.sum(c * c), torch.sum(c))


def _jax_example_fn(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    c, _ = jax.lax.scan(body, x, None, length=4)
    return jnp.where(jnp.sum(c) > 0, jnp.sum(c * c), jnp.sum(c))


def test_build_psg_kinds_and_structure():
    x, w = torch.ones(4, 8), torch.ones(8, 8)
    psg = build_psg(_example_fn, x, w)
    stats = psg.stats()
    assert stats["Loop"] == 1 and stats["Comp"] >= 2
    assert stats["total"] == len(psg.vertices)
    loop = psg.by_kind(LOOP)[0]
    kids = psg.children(loop.vid)
    assert [psg.vertices[k].name for k in kids] == ["mm", "tanh"]
    assert loop.meta["trip_count"] == 4
    body_flops = sum(psg.vertices[k].flops for k in kids)
    assert loop.flops == pytest.approx(4 * body_flops)
    # the same counters as the JAX package's PSG of the same program
    jloop = jax_build_psg(_jax_example_fn, jnp.ones((4, 8)),
                          jnp.ones((8, 8))).by_kind(LOOP)[0]
    assert loop.flops == jloop.flops


def _cond_fn(x, w):
    def body(c, i):
        c = cond(i % 2 == 0, lambda v: torch.tanh(v @ w), lambda v: v, c,
                 name="even")
        return c * 2.0, None
    c, _ = scan(body, x, range(4), name="body")
    return torch.sum(c)


def _jax_cond_fn(x, w):
    def body(c, i):
        c = jax.lax.cond(i % 2 == 0, lambda v: jnp.tanh(v @ w),
                         lambda v: v, c)
        return c * 2.0, None
    c, _ = jax.lax.scan(body, x, jnp.arange(4))
    return jnp.sum(c)


def test_cond_is_a_branch_vertex_in_the_loop():
    x, w = torch.ones(4, 8), torch.ones(8, 8)
    psg = build_psg(_cond_fn, x, w)
    loop = psg.by_kind(LOOP)[0]
    (branch,) = psg.by_kind(BRANCH)
    assert branch.parent == loop.vid and branch.name == "cond:even"
    assert [psg.vertices[k].name for k in psg.children(branch.vid)] == \
        ["mm", "tanh"]
    assert branch.flops == pytest.approx(
        sum(psg.vertices[k].flops for k in psg.children(branch.vid)))
    assert "test_torch_psg.py" in branch.source
    # the loop's counters sum its iterations: two run the arm
    jpsg = jax_build_psg(_jax_cond_fn, jnp.ones((4, 8)), jnp.ones((8, 8)))
    (jbranch,) = jpsg.by_kind(BRANCH)
    assert jpsg.vertices[jbranch.parent].kind == LOOP
    assert branch.flops == pytest.approx(jbranch.flops)
    # its backward: a Branch inside the backward loop, and the arm runs
    x.requires_grad_(True)

    def grad_fn(x, w):
        with torch.enable_grad():
            xs = x.detach().requires_grad_(True)
            return torch.autograd.grad(_cond_fn(xs, w), xs)[0]

    g = build_psg(grad_fn, x.detach(), w)
    bwd = [v for v in g.by_kind(LOOP) if v.name == "scan:body.grad"]
    assert len(bwd) == 1
    assert [b.name for b in g.by_kind(BRANCH)] == ["cond:even",
                                                   "cond:even.grad"]
    assert g.by_kind(BRANCH)[1].parent == bwd[0].vid
    xv = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    want = xv
    for i in range(4):
        want = (torch.tanh(want @ w) if i % 2 == 0 else want) * 2.0
    assert torch.equal(_cond_fn(xv, w), torch.sum(want))


def test_psg_source_attribution():
    psg = build_psg(_example_fn, torch.ones(4, 8), torch.ones(8, 8))
    srcs = [v.source for v in psg.vertices if v.source]
    assert any("test_torch_psg.py" in s for s in srcs)
    assert not any("psg.py:" in s and "test_torch" not in s for s in srcs)


def test_psg_json_roundtrip():
    psg = build_psg(_example_fn, torch.ones(4, 8), torch.ones(8, 8))
    clone = PSG.from_json(psg.to_json())
    assert clone.stats() == psg.stats()
    assert clone.edges == psg.edges
    assert [v.kind for v in clone.vertices] == [v.kind for v in psg.vertices]


def test_contraction_reduces_and_preserves():
    psg = build_psg(_example_fn, torch.ones(4, 8), torch.ones(8, 8))
    cpsg, mapping = contract(psg, max_loop_depth=10)
    assert len(cpsg.vertices) <= len(psg.vertices)
    assert set(mapping) >= {v.vid for v in psg.vertices}
    orig = sum(v.flops for v in psg.vertices if v.parent == psg.root)
    got = sum(v.flops for v in cpsg.vertices if v.parent == cpsg.root)
    assert got == pytest.approx(orig)


def test_contraction_depth_pruning():
    def nested(x):
        def outer(c, _):
            c2, _ = scan(lambda c2, _: (torch.tanh(c2) * 1.5, None), c,
                         range(3), name="inner")
            return c2, None
        c, _ = scan(outer, x, range(2), name="outer")
        return torch.sum(c)

    psg = build_psg(nested, torch.ones(4))
    outer = psg.by_kind(LOOP)[0]
    inner = psg.by_kind(LOOP)[1]
    assert (outer.meta["trip_count"], inner.meta["trip_count"]) == (2, 3)
    assert inner.parent == outer.vid
    deep, _ = contract(psg, max_loop_depth=10)
    shallow, _ = contract(psg, max_loop_depth=1)
    assert shallow.stats()["Loop"] < deep.stats()["Loop"]
    f_deep = sum(v.flops for v in deep.vertices if v.parent == deep.root)
    f_shallow = sum(v.flops for v in shallow.vertices
                    if v.parent == shallow.root)
    assert f_shallow == pytest.approx(f_deep)


def test_scan_outside_a_trace_is_a_loop():
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    for remat in (False, True):
        c, ys = scan(lambda c, i: (torch.tanh(c @ w), i), x, range(3),
                     name="t", remat=remat)
        want = x
        for _ in range(3):
            want = torch.tanh(want @ w)
        assert torch.equal(c, want) and ys == [0, 1, 2]


def test_scan_scopes_show_in_an_eager_profile():
    w = torch.ones(8, 8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scan(lambda c, _: (torch.tanh(c @ w), None), torch.ones(4, 8),
             range(2), name="t", remat=True)
    keys = {e.key for e in prof.key_averages()}
    assert {"scalana.iter:t:0", "scalana.iter:t:1"} <= keys
    assert any(k.startswith("scalana.loop:t@test_torch_psg.py:")
               for k in keys), keys


def test_traced_graph_replays_the_program():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(2))
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(3))
    tr = trace(_example_fn, x, w)
    out = tr.rebuild_out(tr.graph_module(*tr.flat_args(x, w)))
    assert torch.equal(out, _example_fn(x, w))


def test_node_costs():
    def f(a, b, c):
        return torch.exp(a @ b).sum() + torch.bmm(c, c).reshape(-1)[0]

    tr = trace(f, torch.ones(3, 5), torch.ones(5, 7), torch.ones(2, 4, 4))
    got = {costs.op_name(n): costs.node_costs(n)
           for n in tr.graph_module.graph.nodes if n.op == "call_function"}
    assert got["mm"] == (2 * 3 * 5 * 7, 4 * (15 + 35 + 21))
    assert got["bmm"] == (2 * 2 * 4 * 4 * 4, 4 * 3 * 32)
    assert got["exp"][0] == 8 * 21
    assert got["sum"][0] == 21
    assert got["view"][0] == 0.0


# ---------------------------------------------------------------------------
# property: contraction invariants on random synthetic PSGs
# ---------------------------------------------------------------------------

@st.composite
def random_psg(draw):
    g = PSG()
    root = g.new_vertex("Root", "root")
    g.root = root.vid
    frontier = [root.vid]
    n = draw(st.integers(5, 40))
    for _ in range(n):
        parent = draw(st.sampled_from(frontier))
        kind = draw(st.sampled_from([COMP, COMP, COMP, LOOP, COMM]))
        depth = g.vertices[parent].depth + (1 if parent != root.vid else 0)
        v = g.new_vertex(kind, kind.lower(), parent=parent, depth=depth)
        if kind == COMP:
            v.flops = float(draw(st.integers(0, 1000)))
        if kind == COMM:
            v.comm_bytes = float(draw(st.integers(1, 10_000)))
            v.comm_kind = "all_reduce"
        if kind == LOOP:
            frontier.append(v.vid)
    for parent in {v.parent for v in g.vertices if v.parent >= 0}:
        kids = g.children(parent)
        for a, b in zip(kids, kids[1:]):
            g.add_edge(a, b, "data")
        for k in kids:
            g.add_edge(parent, k, "control")

    def rollup(vid):
        v = g.vertices[vid]
        kids = g.children(vid)
        for k in kids:
            rollup(k)
        if v.kind == LOOP:
            v.flops = sum(g.vertices[k].flops for k in kids)
            v.comm_bytes = sum(g.vertices[k].comm_bytes for k in kids)
    for k in g.children(root.vid):
        rollup(k)
    return g


@settings(max_examples=30, deadline=None)
@given(psg=random_psg(), depth=st.integers(0, 4))
def test_contract_properties(psg, depth):
    cpsg, mapping = contract(psg, max_loop_depth=depth)
    assert len(cpsg.by_kind(COMM)) == len(psg.by_kind(COMM))
    assert (sum(v.comm_bytes for v in cpsg.by_kind(COMM))
            == pytest.approx(sum(v.comm_bytes for v in psg.by_kind(COMM))))
    assert len(cpsg.vertices) <= len(psg.vertices)
    assert set(mapping) >= {v.vid for v in psg.vertices}

    def subtree_flops(g, vid):
        v = g.vertices[vid]
        kids = g.children(vid)
        if v.kind == LOOP and kids:
            return v.flops
        if kids:
            return v.flops + sum(subtree_flops(g, k) for k in kids)
        return v.flops
    orig = sum(subtree_flops(psg, k) for k in psg.children(psg.root))
    got = sum(subtree_flops(cpsg, k) for k in cpsg.children(cpsg.root))
    assert got == pytest.approx(orig, rel=1e-6)
    # the same contraction as the JAX package's on the same graph
    from repro.core.graph import PSG as JaxPSG
    jc, jmap = jax_contract(JaxPSG.from_json(psg.to_json()), depth)
    assert jc.to_json() == cpsg.to_json() and jmap == mapping

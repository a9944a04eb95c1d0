"""The port's host spans and collector counters (``repro_torch.core.spans``)
on the CPU: totals that nest and add up, the Trainer's and the profiler's
timers read from their spans, the collector's counter and its range in a
``torch.profiler`` trace, one vertex span a segment switch, and a traced
train step that holds no node of any span.
"""
import gc
import hashlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core import spans
from repro_torch.core.profiler import GraphProfiler
from repro_torch.core.psg import scan, trace
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, constant
from repro_torch.training import Trainer, TrainState, make_train_step

SPAN_PREFIXES = ("trainer.", "profiler.", "psg.", "python.gc")


def _fn(x, w):
    c, _ = scan(lambda c, _: (torch.tanh(c @ w), None), x, range(3),
                name="body")
    return torch.sum(torch.relu(c))


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_span_totals_nest_and_add_up():
    before = dict(spans.TOTALS.get("t.outer", {"count": 0}))
    with spans.collect() as outer:
        with spans.span("t.outer") as o:
            with spans.collect() as inner:
                for _ in range(3):
                    with spans.span("t.inner"):
                        time.sleep(0.002)
            with spans.span("t.other"):
                pass
    assert set(inner) >= {"t.inner"} and "t.outer" not in inner
    assert outer["t.inner"] == inner["t.inner"]
    assert outer["t.inner"]["count"] == 3 and outer["t.other"]["count"] == 1
    st = outer["t.inner"]
    assert 0.006 <= st["seconds"] <= o.seconds
    assert 0.002 <= st["longest"] <= st["seconds"]
    assert st["seconds"] + outer["t.other"]["seconds"] <= o.seconds
    assert outer["t.outer"] == {"count": 1, "seconds": o.seconds,
                                "longest": o.seconds}
    assert spans.TOTALS["t.outer"]["count"] == before["count"] + 1
    # a span opened and closed by hand totals under its own key
    sp = spans.span("t.hand:7", "t.hand").open()
    with spans.collect() as hand:
        assert sp.close() == sp.seconds >= 0
    assert hand["t.hand"]["count"] == 1 and "t.hand:7" not in hand


def test_spans_are_ranges_of_a_profiler_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("t.range.outer"):
            with spans.span("t.range.inner"):
                torch.ones(4).sum()
    ev = {n: (s, e) for n, s, e in _events(prof)}
    (os_, oe), (is_, ie) = ev["t.range.outer"], ev["t.range.inner"]
    assert os_ <= is_ <= ie <= oe


def test_gc_counter_and_its_range_inside_the_open_span():
    n0 = spans.TOTALS.get("python.gc:gen2", {"count": 0})["count"]
    with spans.collect() as got:
        gc.collect()
    assert got["python.gc:gen2"]["count"] == 1
    assert got["python.gc:gen2"]["seconds"] > 0
    assert spans.TOTALS["python.gc:gen2"]["count"] == n0 + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("t.gc.open"):
            gc.collect()
    ev = _events(prof)
    open_ = [(s, e) for n, s, e in ev if n == "t.gc.open"]
    gc2 = [(s, e) for n, s, e in ev if n == "python.gc:gen2"]
    assert len(open_) == 1 and gc2
    (os_, oe), = open_
    assert any(os_ <= s <= e <= oe for s, e in gc2)


def _switches(prof) -> int:
    out, last = 0, None
    for n in prof.traced.graph_module.graph.nodes:
        seg = prof._segment.get(n)
        if seg is not None and seg != last:
            out, last = out + 1, seg
    return out


def test_profiler_step_times_are_its_step_spans():
    x, w = torch.randn(16, 32), torch.randn(32, 32) / 8
    prof = GraphProfiler(_fn, (x, w), sample_every=2)
    with spans.collect() as got:
        for _ in range(6):
            prof.step(x, w)
    eager, sampled = got["profiler.eager_step"], got["profiler.sampled_step"]
    assert eager["count"] == 3 and sampled["count"] == 3
    assert sum(prof.step_times) == pytest.approx(
        eager["seconds"] + sampled["seconds"], rel=1e-12)
    assert max(prof.step_times[1::2]) == sampled["longest"]
    assert max(prof.step_times[0::2]) == eager["longest"]
    # a sampled step's entry covers its vertex times, the interpreter's
    # construction and the output's rebuild
    for j, step_s in enumerate(prof.step_times[1::2]):
        vertex_s = sum(ts[j] for ts in prof._vertex_times.values())
        assert 0 < vertex_s <= step_s
    assert got["profiler.vertex"]["seconds"] == pytest.approx(
        sum(sum(ts) for ts in prof._vertex_times.values()), rel=1e-12)
    assert got["profiler.interpreter"]["count"] == 3
    assert got["profiler.rebuild"]["count"] == 3
    inner = sum(got[k]["seconds"] for k in (
        "profiler.vertex", "profiler.interpreter", "profiler.rebuild"))
    assert inner <= sampled["seconds"]


def test_one_vertex_span_a_segment_switch():
    x, w = torch.randn(8, 16), torch.randn(16, 16) / 4
    prof = GraphProfiler(_fn, (x, w), sample_every=1)
    switches = _switches(prof)
    assert switches >= len(prof.psg.children(prof.psg.root))
    with spans.collect() as got:
        prof.step(x, w)
    assert got["profiler.vertex"]["count"] == switches
    # a fence before the run, one a switch and one after the run
    assert got["profiler.fence"]["count"] == switches + 2
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        prof.step(x, w)
    names = [n for n, _, _ in _events(tp) if n.startswith("profiler.vertex:")]
    assert len(names) == switches
    tops = set(prof.psg.children(prof.psg.root))
    assert {int(n.split(":")[1]) for n in names} <= tops


def test_profiler_set_up_spans_and_trace_s():
    x, w = torch.randn(8, 16), torch.randn(16, 16)
    prof = GraphProfiler(_fn, (x, w))
    ts = prof.trace_spans
    assert prof.trace_s == ts["profiler.trace"]["seconds"] > 0
    for key in ("psg.make_fx", "psg.build", "profiler.contract"):
        assert ts[key]["count"] == 1
    assert (ts["psg.make_fx"]["seconds"] + ts["psg.build"]["seconds"]
            <= ts["profiler.trace"]["seconds"])
    assert spans.recent()[-1] == ("profiler.init", ts)


def test_trainer_spans_a_call_and_step_wall_times():
    run = RunConfig(arch="mamba2-130m", total_steps=8, warmup_steps=2,
                    scalana=True, scalana_sample_every=2)
    tr = Trainer(run, arch_cfg=get_smoke("mamba2-130m"),
                 shape=ShapeConfig("smoke", 16, 2, "train"), device="cpu")
    state = tr.train(num_steps=4, resume=False)
    tr.train(num_steps=2, state=state, resume=False)
    assert len(tr.span_log) == 2
    first, second = tr.span_log
    assert "profiler.trace" in first and "profiler.trace" not in second
    assert spans.recent()[-1] == ("trainer.train", second)
    for entry, walls in ((first, tr.step_wall_times[:4]),
                         (second, tr.step_wall_times[4:])):
        n = len(walls)
        assert entry["trainer.train"]["count"] == 1
        for key in ("trainer.batch", "trainer.put_batch", "trainer.step",
                    "trainer.readback"):
            assert entry[key]["count"] == n, key
        assert entry["trainer.step"]["seconds"] == pytest.approx(
            sum(walls), rel=1e-12)
        assert entry["trainer.step"]["longest"] == max(walls)
        handoff = sum(entry[k]["seconds"] for k in (
            "trainer.batch", "trainer.put_batch", "trainer.readback"))
        assert handoff + entry["trainer.step"]["seconds"] \
            <= entry["trainer.train"]["seconds"]
        steps = (entry["profiler.eager_step"]["count"]
                 + entry.get("profiler.sampled_step", {"count": 0})["count"])
        assert steps == n
    assert first["profiler.sampled_step"]["count"] == 2
    assert second["profiler.sampled_step"]["count"] == 1
    # the profiler's step span lies inside the Trainer's
    assert len(tr.profiler.step_times) == len(tr.step_wall_times)
    assert all(p <= w for p, w in zip(tr.profiler.step_times,
                                      tr.step_wall_times))


def test_trainer_checkpoint_span(tmp_path):
    run = RunConfig(arch="mamba2-130m", total_steps=2, warmup_steps=1,
                    scalana=False, checkpoint_dir=str(tmp_path),
                    checkpoint_every=1)
    tr = Trainer(run, arch_cfg=get_smoke("mamba2-130m"),
                 shape=ShapeConfig("smoke", 16, 2, "train"), device="cpu")
    tr.train(num_steps=2)
    entry, = tr.span_log
    # one save a step, and the last call's blocking save
    assert entry["trainer.checkpoint"]["count"] == 3


def test_trainer_call_frees_its_first_state():
    """No frame of ``train`` keeps the state it was given once the first
    step has replaced it (the full-size cells need the memory)."""
    import weakref
    run = RunConfig(arch="mamba2-130m", total_steps=3, warmup_steps=1,
                    scalana=False)
    tr = Trainer(run, arch_cfg=get_smoke("mamba2-130m"),
                 shape=ShapeConfig("smoke", 16, 2, "train"), device="cpu")
    held = [tr.init_state()]
    first = weakref.ref(held[0].opt.step)
    alive = []

    class Data:
        def __init__(self, data):
            self.data = data

        def batch(self, i):
            alive.append(first() is not None)
            return self.data.batch(i)

    tr.dataset = Data(tr.dataset)
    tr.train(num_steps=3, state=held.pop(), resume=False)
    assert alive == [True, False, False]


def _digest(gm) -> str:
    h = hashlib.sha1()
    for n in gm.graph.nodes:
        h.update(f"{n.op}|{n.target}|{n.name}|{[str(a) for a in n.args]}\n"
                 .encode())
    return h.hexdigest()


def _span_markers(gm):
    return [n for n in gm.graph.nodes
            if any(isinstance(a, str) and a.startswith(SPAN_PREFIXES)
                   for a in n.args)]


# FX nodes, full PSG vertices, contracted PSG vertices of the smoke train
# step at tokens (2, 33), as the PSG builder made them before the spans
BEFORE = {"mamba2-130m": (2891, 1674, 14), "zamba2-2.7b": (6205, 2323, 21)}


@pytest.mark.parametrize("arch", sorted(BEFORE))
def test_traced_train_step_holds_no_span(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    step = make_train_step(model, RunConfig(arch=arch), constant(1e-3))
    state = TrainState(params=params, opt=adamw_init(params), residual=None,
                       step=torch.zeros((), dtype=torch.int32))
    ids = torch.randint(0, cfg.vocab_size, (2, 33),
                        generator=torch.Generator().manual_seed(0))
    prof = GraphProfiler(step, (state, {"tokens": ids}), sample_every=2)
    gm = prof.traced.graph_module
    assert not _span_markers(gm)
    assert (len(gm.graph.nodes), len(prof.psg_full.vertices),
            len(prof.psg.vertices)) == BEFORE[arch]
    # traced again while a torch.profiler records (spans and collector
    # ranges live): node for node the same graph
    with profile(activities=[ProfilerActivity.CPU]):
        again = trace(step, state, {"tokens": ids})
    assert _digest(again.graph_module) == _digest(gm)
    assert len(again.psg.vertices) == BEFORE[arch][1]


def test_collection_inside_a_trace_adds_no_node():
    def f(x):
        y = torch.tanh(x) * 2
        gc.collect()                  # the hook runs inside make_fx
        return y.sum()

    with spans.collect() as got:
        with profile(activities=[ProfilerActivity.CPU]):
            tr = trace(f, torch.ones(4))
    assert got["python.gc:gen2"]["count"] >= 1
    assert not _span_markers(tr.graph_module)
    ops = [n for n in tr.graph_module.graph.nodes
           if n.op == "call_function"]
    assert not any("record_function" in str(n.target) for n in ops)

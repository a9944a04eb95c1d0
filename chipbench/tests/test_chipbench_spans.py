"""The span metrics' readers: on a synthetic record, on the program's own
record of a CPU Trainer's calls, and None where there are no spans."""
import pytest

from chipbench.harness import registry, window_spans

NAMES = ("handoff_ms", "gc_pause_ms", "sampled_host_ms", "psg_trace_s")


def _st(count, seconds, longest=None):
    return {"count": count, "seconds": seconds,
            "longest": seconds if longest is None else longest}


def _record():
    window = {
        "trainer.train": _st(2, 10.0), "trainer.step": _st(8, 9.0, 2.0),
        "trainer.batch": _st(8, 0.008), "trainer.put_batch": _st(8, 0.004),
        "trainer.readback": _st(8, 0.002),
        "profiler.eager_step": _st(6, 6.0, 1.0),
        "profiler.sampled_step": _st(2, 2.9, 1.5),
        "profiler.vertex": _st(400, 2.5, 0.5),
        "python.gc:gen0": _st(100, 0.01), "python.gc:gen1": _st(10, 0.01),
        "python.gc:gen2": _st(1, 1.2)}
    trace = {"profiler.trace": _st(1, 61.5), "psg.make_fx": _st(1, 40.0),
             "psg.build": _st(1, 20.0), "profiler.contract": _st(1, 0.5)}
    return {"spans": {"window": window, "trace": trace}}


def _read(name, run):
    return registry.metric_reader(name).read(run)


def test_readers_on_a_synthetic_record():
    run = _record()
    assert _read("handoff_ms", run) == pytest.approx(1e3 * 0.014 / 8)
    assert _read("gc_pause_ms", run) == pytest.approx(1e3 * 1.22 / 8)
    assert _read("sampled_host_ms", run) == pytest.approx(1e3 * 0.4 / 2)
    assert _read("psg_trace_s", run) == 61.5


def test_checkpoint_span_counts_in_the_hand_off():
    run = _record()
    run["spans"]["window"]["trainer.checkpoint"] = _st(1, 0.8)
    assert _read("handoff_ms", run) == pytest.approx(1e3 * 0.814 / 8)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans(name):
    assert _read(name, {}) is None
    # a run without a device trace: the program's record is not read
    assert _read(name, {"step_wall_s": [1.0], "window_s": 1.0}) is None
    # no sampled step, no trace spans
    empty = {"spans": {"window": {"trainer.step": _st(4, 1.0)},
                       "trace": {}}}
    if name in ("sampled_host_ms", "psg_trace_s"):
        assert _read(name, empty) is None


def test_no_collection_reads_zero():
    run = _record()
    for g in range(3):
        del run["spans"]["window"][f"python.gc:gen{g}"]
    assert _read("gc_pause_ms", run) == 0.0


def test_readers_on_the_programs_record():
    """A traced run's record without ``spans``: the program's trailing
    ``Trainer.train`` calls that hold its steps."""
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.training import Trainer
    run = RunConfig(arch="mamba2-130m", total_steps=8, warmup_steps=2,
                    scalana=True, scalana_sample_every=2)
    tr = Trainer(run, arch_cfg=get_smoke("mamba2-130m"),
                 shape=ShapeConfig("smoke", 16, 2, "train"), device="cpu")
    state = tr.train(num_steps=2, resume=False)          # the warm-up
    state = tr.train(num_steps=4, state=state, resume=False)
    tr.train(num_steps=2, state=state, resume=False)     # the traced call
    walls = tr.step_wall_times[2:]
    rec = {"trace": {"window_s": 1.0}, "step_wall_s": walls}
    got = window_spans.of_run(rec)
    want = window_spans.summed(tr.span_log[1:])
    assert got["window"] == want
    assert got["trace"] is tr.profiler.trace_spans
    assert _read("handoff_ms", rec) == pytest.approx(1e3 * sum(
        want[k]["seconds"] for k in ("trainer.batch", "trainer.put_batch",
                                     "trainer.readback")) / 6)
    assert _read("psg_trace_s", rec) == tr.profiler.trace_s
    host = _read("sampled_host_ms", rec)
    assert host == pytest.approx(1e3 * (
        want["profiler.sampled_step"]["seconds"]
        - want["profiler.vertex"]["seconds"]) / 3)
    assert host >= 0 and _read("gc_pause_ms", rec) >= 0
    # steps that are not the trailing calls' are not read
    assert window_spans.of_run(dict(rec, step_wall_s=walls[1:])) is None
    assert window_spans.of_run(
        dict(rec, step_wall_s=[w + 1e-3 for w in walls])) is None

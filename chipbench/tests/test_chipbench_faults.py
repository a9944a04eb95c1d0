"""A whole run of a cell (smoke size, the CPU, the harness's look for a
card skipped) comes out ``correct`` as it is, and not ``correct`` with
the timed path broken underneath in each way the cell can break: a step
that returns its state unchanged, half of the batch left out (the mean
over the rest), the step's loss altered where it is produced, in every
step or in the window's steps alone, the sampled step recording no
times, or times that its own step's clock or the plain measure of its
vertices contradicts (a constant, each vertex given the next one's, or
twice what passed), the replay or the detection's answer altered.  (One
card: no exchange between chips to leave out.  The profiler's fences
taken out change nothing on the CPU, whose operations are synchronous:
``chipbench/control.py --fault-seeds`` reads that fault on the card.)"""
import pytest

from chipbench.harness import bench
from chipbench.tests._smoke import smoke_cell


def _wrap_step(monkeypatch, change):
    import repro_torch.training.trainer as tr
    make = tr.make_train_step

    def broken(model, run, lr_fn):
        step = make(model, run, lr_fn)
        return lambda state, batch: change(step, state, batch)

    monkeypatch.setattr(tr, "make_train_step", broken)


def unchanged(monkeypatch):
    def change(step, state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    _wrap_step(monkeypatch, change)


def half_batch(monkeypatch):
    def change(step, state, batch):
        return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    _wrap_step(monkeypatch, change)


def loss_altered(monkeypatch):
    def change(step, state, batch):
        state, metrics = step(state, batch)
        return state, dict(metrics, loss=metrics["loss"] * 1.001)
    _wrap_step(monkeypatch, change)


def window_loss_altered(monkeypatch):
    """The loss altered from the fourth eager step on: the warm-up's
    steps 1-3 run eagerly, step 4 through the traced graph, so only the
    window's steps are touched."""
    calls = []

    def change(step, state, batch):
        calls.append(1)
        state, metrics = step(state, batch)
        if len(calls) >= 4:
            metrics = dict(metrics, loss=metrics["loss"] * 1.001)
        return state, metrics
    _wrap_step(monkeypatch, change)


def _recorded_times(monkeypatch, change):
    from repro_torch.core.profiler import _TimedRun
    timed = _TimedRun.timed

    def recorded(self, *args):
        out = timed(self, *args)
        self.times = {vid: change(t) for vid, t in self.times.items()}
        return out
    monkeypatch.setattr(_TimedRun, "timed", recorded)


def times_constant(monkeypatch):
    _recorded_times(monkeypatch, lambda t: 1e-6)


def times_rotated(monkeypatch):
    """Each vertex given the time of the next: the right total, the
    wrong vertices."""
    from repro_torch.core.profiler import _TimedRun
    timed = _TimedRun.timed

    def recorded(self, *args):
        out = timed(self, *args)
        vids = sorted(self.times)
        self.times = {v: self.times[vids[(i + 1) % len(vids)]]
                      for i, v in enumerate(vids)}
        return out
    monkeypatch.setattr(_TimedRun, "timed", recorded)


def times_doubled(monkeypatch):
    _recorded_times(monkeypatch, lambda t: 2.0 * t)


def no_samples(monkeypatch):
    from repro_torch.core.profiler import GraphProfiler
    monkeypatch.setattr(GraphProfiler, "_sampled_step",
                        lambda self, *args: self.fn(*args))


def replay_altered(monkeypatch):
    import repro_torch.core.inject as inject
    sim = inject.simulate

    def altered(psg, n, base, **kw):
        res = sim(psg, n, base, **kw)
        vid = psg.children(psg.root)[0]
        res.ppg.perf.set_entries([3], vid, res.ppg.get_time(3, vid) * 1.5)
        return res
    monkeypatch.setattr(inject, "simulate", altered)


def detection_altered(monkeypatch):
    import repro_torch.core as core
    detect = core.detect_abnormal
    monkeypatch.setattr(core, "detect_abnormal",
                        lambda *a, **kw: detect(*a, **kw)[:-1])


@pytest.mark.parametrize("config", ["mamba2-130m", "zamba2-2.7b"])
def test_a_sound_run_is_correct(config):
    run = bench.execute(smoke_cell(config))
    assert run["correct"], run["checks"]


@pytest.mark.parametrize("fault,number", [
    (unchanged, "change_gap"), (half_batch, "loss_gap"),
    (loss_altered, "loss_gap"), (window_loss_altered, "loss_gap"),
    (no_samples, "vertex_samples_missing"),
    (times_constant, "vertex_time_short"),
    (times_rotated, "vertex_time_short"), (times_doubled, "vertex_time_over"),
    (replay_altered, "replay_mismatch"),
    (detection_altered, "abnormal_mismatch")],
    ids=lambda f: getattr(f, "__name__", f))
def test_a_broken_run_is_not_correct(fault, number, monkeypatch):
    fault(monkeypatch)
    run = bench.execute(smoke_cell("mamba2-130m"))
    assert not run["correct"]
    check = run["checks"][number]
    assert not check["value"] <= check["limit"]

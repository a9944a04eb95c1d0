"""The port's scenario bank against the JAX package's, end to end.

The two smoke scenarios at 512 processes: the port replays the same
committed traces, detects on the torch backend (plain versions on the
CPU), backtracks and ranks root causes; every flagged and reported
identity must equal the JAX package's numpy run, and the port's run must
clear the declared accuracy floors.
"""
import pytest

from repro.scenarios import get_scenario as ref_scenario
from repro_torch.scenarios import SMOKE_SCENARIOS, get_scenario, \
    list_traces, run_and_score


def _key(result):
    return (tuple((a.vid, a.proc, a.time, a.typical)
                  for a in result.abnormal),
            tuple(d.vid for d in result.non_scalable),
            tuple(tuple(p.nodes) for p in result.paths),
            tuple(n for n, _, _ in result.reported))


@pytest.mark.parametrize("name", SMOKE_SCENARIOS)
def test_smoke_scenario_equals_reference_and_passes_floors(name):
    sc = get_scenario(name)
    got, score = run_and_score(sc, 512, backend="torch", device="cpu")
    want = ref_scenario(name).run(512, backend="numpy")
    assert got.backend == "torch"
    assert _key(got) == _key(want)
    for a, b in zip(got.non_scalable, want.non_scalable):
        assert abs(a.slope - b.slope) <= 1e-12 * max(abs(b.slope), 1.0)
    assert score.passes(sc.truth), score.row()


def test_non_scalable_scenario_equals_reference():
    """The cross-scale channel (a four-scale series, host-stacked)."""
    got, score = run_and_score(get_scenario("amdahl_serial_fraction"), 512,
                               backend="torch", device="cpu")
    want = ref_scenario("amdahl_serial_fraction").run(512, backend="numpy")
    assert got.non_scalable and _key(got) == _key(want)
    for a, b in zip(got.non_scalable, want.non_scalable):
        assert abs(a.slope - b.slope) <= 1e-12 * max(abs(b.slope), 1.0)
    assert score.passes(got.truth), score.row()


def test_port_carries_the_committed_traces():
    assert list_traces() == ["moe_train", "tinyllama_decode",
                             "tinyllama_train"]

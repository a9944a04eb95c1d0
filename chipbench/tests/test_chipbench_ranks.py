"""The launcher for a cell whose traffic sets ``ranks``: one process a
rank in one group with the backend the program would pick (Gloo on the
CPU), rank 0's value back, every process ended.  On the CPU with a stub
worker; not proved on the card."""
import multiprocessing as mp

import pytest

from chipbench.harness import ranks


def test_two_ranks_join_one_group():
    got = ranks.launch(2, "chipbench.tests._stub_worker:stub", {"x": 1},
                       "cpu", timeout_s=120)
    assert got == {"sum": 3.0, "world": 2, "backend": "gloo",
                   "payload": {"x": 1}}
    assert not mp.active_children()


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        ranks.launch(2, "chipbench.tests._stub_worker:fail_on_one", {},
                     "cpu", timeout_s=120)
    assert not mp.active_children()


def test_the_training_cell_over_two_ranks():
    """The training cell with ``ranks: 2`` on the CPU (Gloo): one rank a
    process, each its rows of the global batch, the step's all-reduce a
    Comm vertex; rank 0 judges against the reference over all the rows."""
    from chipbench.harness import bench
    from chipbench.tests._smoke import smoke_cell
    cell = smoke_cell("mamba2-130m", batch=1)
    cell["traffic"]["ranks"] = 2
    run = bench.execute(cell)
    assert run["correct"], run["checks"]
    assert run["tokens"] == run["steps"] * 2 * cell["traffic"]["seq_len"]

"""Python's cyclic collections a step: the seconds in collections of
every generation (the program's ``python.gc:gen<N>`` counters) during
the window's ``Trainer.train`` calls, over the window's steps, in ms."""
from chipbench.harness import window_spans

GENERATIONS = tuple(f"python.gc:gen{g}" for g in range(3))


def read(run):
    sp = window_spans.of_run(run)
    steps = window_spans.count(sp["window"], "trainer.step") if sp else 0
    if not steps:
        return None
    return 1e3 * window_spans.seconds(sp["window"], *GENERATIONS) / steps

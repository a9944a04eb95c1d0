"""The sampled path's host work outside the fenced graph run, a sampled
step: the ``profiler.sampled_step`` spans less the ``profiler.vertex``
spans (each vertex's stretch of the graph with its fence) over the
window's sampled steps, in ms."""
from chipbench.harness import window_spans


def read(run):
    sp = window_spans.of_run(run)
    n = window_spans.count(sp["window"], "profiler.sampled_step") if sp else 0
    if not n:
        return None
    w = sp["window"]
    return 1e3 * (window_spans.seconds(w, "profiler.sampled_step")
                  - window_spans.seconds(w, "profiler.vertex")) / n

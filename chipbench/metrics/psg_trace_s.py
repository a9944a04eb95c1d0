"""The set-up's trace of the train step into the PSG: the program's
``profiler.trace`` span (``make_fx`` and the PSG's build), in s."""
from chipbench.harness import window_spans


def read(run):
    sp = window_spans.of_run(run)
    trace = (sp.get("trace") or {}).get("profiler.trace") if sp else None
    return None if trace is None else trace["seconds"]

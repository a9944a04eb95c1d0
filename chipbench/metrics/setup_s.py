"""Seconds from the process's start to the window's, the judge's reads
left out: imports, weights, the Trainer, the PSG trace, the warm-up
(and, on a checkout's first run, every build)."""


def read(run):
    return run.get("setup_s")

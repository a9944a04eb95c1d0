"""Tokens of the window's steps over the window's host-clock seconds
(sampled steps, the data hand-off and the loss read-back included)."""


def read(run):
    if "tokens" not in run or not run.get("window_s"):
        return None
    return run["tokens"] / run["window_s"]

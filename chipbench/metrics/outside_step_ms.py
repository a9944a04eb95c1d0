"""The trainer loop's own time a step: the window's host-clock seconds
less the Trainer's fenced step times over them, per step, in ms (the
data hand-off, the loss read-back, the loop)."""


def read(run):
    walls = run.get("step_wall_s") or []
    if not walls or not run.get("window_s"):
        return None
    return 1e3 * (run["window_s"] - sum(walls)) / len(walls)

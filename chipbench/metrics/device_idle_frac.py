"""The share of the traced window in which no kernel, copy or fill ran on
the device, from the ``torch.profiler`` timeline, in %."""


def read(run):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])

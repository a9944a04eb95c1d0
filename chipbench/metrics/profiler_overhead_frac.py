"""The sampling profiler's overhead over the window, by the arithmetic of
``GraphProfiler.overhead_estimate``: the sampled steps' excess over the
median fast step, over the rest of the time, in %."""
import statistics


def read(run):
    times, sampled = run.get("profiler_step_s") or [], run.get("sampled")
    if not times or not sampled or len(times) != len(sampled):
        return None
    fast = [t for t, s in zip(times, sampled) if not s]
    slow = [t for t, s in zip(times, sampled) if s]
    if not fast or not slow:
        return None
    base = statistics.median(fast)
    extra = sum(max(t - base, 0.0) for t in slow)
    return 100.0 * extra / max(sum(times) - extra, 1e-12)

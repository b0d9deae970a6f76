"""Model step layer: host milliseconds per engine step outside the
wait for the device (the engine's step-phase spans, less
``host_sync`` and ``prefill``, which end in a wait for the device), before the profiled span."""
from harness.stats import mean


def read(run):
    xs = [s["enqueue_s"] for s in run.steps if not s["profiled"]]
    return 1e3 * mean(xs) if xs and any(xs) else None

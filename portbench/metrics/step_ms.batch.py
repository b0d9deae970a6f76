"""Engine layer: mean wall milliseconds of the engine steps of the
window before the profiled span, on the harness's host clock."""
from harness.stats import mean


def read(run):
    dts = [s["dt"] for s in run.steps if not s["profiled"]]
    return 1e3 * mean(dts) if dts else None

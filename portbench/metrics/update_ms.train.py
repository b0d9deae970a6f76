"""Training layer (the mask products and AdamW): the window's median
step milliseconds less one forward and backward pass alone, timed
with CUDA events after the window."""
import statistics


def read(run):
    fb = getattr(run.driver, "fwd_bwd_s", None)
    if fb is None or not run.steps:
        return None
    return 1e3 * (statistics.median(s["dt"] for s in run.steps) - fb)

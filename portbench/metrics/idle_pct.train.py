"""Device layer: share of the profiled span of train steps in
which no device operation ran, in %."""
def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

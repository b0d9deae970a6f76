"""Engine layer: 90th percentile, over the requests due before the
profiled span, of the milliseconds from a request's due time to the
start of the step that granted it a slot."""
from harness.stats import percentile


def read(run):
    d = run.driver
    cut = d.t0 + d.ctx.seconds - run.mix["profile_s"]
    waits = [t.t_admit - t.t_sched for t in d.tracks
             if t.t_sched < cut and t.t_admit is not None]
    return 1e3 * percentile(waits, 90) if waits else None

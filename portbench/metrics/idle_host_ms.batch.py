"""Engine layer: device idle milliseconds per engine step while the host
was anywhere but inside ``serve.decode``: another phase of the step
(schedule, host_sync, sample, ...), between phases, or between steps."""
from harness import spans


def read(run):
    sp = spans.of(run)
    idle = sp.idle_ms() if sp else None
    if idle is None:
        return None
    return spans.per_step(run, sum(v for k, v in idle.items()
                                   if k != "serve.decode"))

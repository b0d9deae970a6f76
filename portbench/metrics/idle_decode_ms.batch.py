"""Model step layer: device idle milliseconds per engine step while the
host was inside the program's ``serve.decode`` range (the device starved
while the host launched the decode step)."""
from harness import spans


def read(run):
    sp = spans.of(run)
    idle = sp.idle_ms() if sp else None
    if idle is None:
        return None
    return spans.per_step(run, idle.get("serve.decode", 0.0))

"""Decode attention layer: device milliseconds per engine step under the
program's ``attn.decode`` ranges in the profiled span (the cache casts,
both products, the mask and the softmax of every attention layer)."""
from harness import spans


def read(run):
    sp = spans.of(run)
    return spans.per_step(run, sp.device_ms("attn.decode")) if sp else None

"""Training layer: device milliseconds per profiled train step under the
program's ``train.update`` ranges (the gradient masks, AdamW and the
parameter masks), read where the update runs."""
from harness import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return spans.per_step(run, sp.device_ms("train.update"),
                          steps_of="train.update")

"""MoE dispatch layer: device milliseconds per engine step under the
program's ``moe`` ranges less under the grouped products nested in them
(``kernel.bitmap_spmm_grouped``, K1g): the router, top-k, sort, bucket
scatter and combine."""
from harness import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return spans.per_step(run, sp.device_ms(
        "moe", skip=("kernel.bitmap_spmm_grouped",)))

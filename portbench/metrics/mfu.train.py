"""The whole train step: 6·N·T plus 12·L·H·hd·S·T per step (the
recompute of checkpointing not counted), over the window's steps' wall
seconds times the bf16 peak, in %."""
from harness.floors import BF16_FLOPS_PER_S, train_step_flops


def read(run):
    m, mix = run.model, run.mix
    if not run.steps:
        return None
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    per = train_step_flops(run.driver.param_count(), m["num_layers"],
                           m["num_heads"], hd, mix["batch"], mix["seq_len"])
    secs = sum(s["dt"] for s in run.steps)
    return 100.0 * per * len(run.steps) / (secs * BF16_FLOPS_PER_S)

"""The whole decode step: the pruned model's operations for every token
the steps before the profiled span processed (two per kept weight met,
the head included, and 4·L·(H·hd)·context for attention; prompt
tokens of prefill calls without their attention), over their wall
seconds times the bf16 peak, in %."""
from harness.floors import BF16_FLOPS_PER_S


def read(run):
    if not run.kept:
        return None
    m = run.model
    d_attn = m["num_heads"] * (m.get("head_dim") or
                               m["d_model"] // m["num_heads"])
    active = run.kept["active"]
    head = run.kept["shapes"].get(f"1x{m['d_model']}x{m['vocab_size']}")
    head = head[0] if head else m["d_model"] * m["vocab_size"]
    ops = secs = 0.0
    for s in run.steps:
        if s["profiled"] or "context" not in s:
            continue
        ops += 2.0 * s["decode_rows"] * active
        ops += 4.0 * m["num_layers"] * d_attn * s["context"]
        ops += 2.0 * s["prefill_rows"] * (active - head)
        secs += s["dt"]
    return 100.0 * ops / (secs * BF16_FLOPS_PER_S) if secs else None

"""Kernel K1 (single-weight bitmap products): the floor seconds of
the products in the profiled span, counted from the pruned weights'
kept values (``harness.floors``), over their device seconds (the
device time under the ``portbench.k1`` label), in %."""
from harness.floors import calls_floor_s


def read(run):
    return roofline(run, grouped=False, label="portbench.k1")


def roofline(run, grouped, label):
    prof = run.profile
    if not prof or not run.kept:
        return None
    spent = prof["labels"].get(label, 0.0)
    calls = [c for c in run.calls if c["grouped"] == grouped]
    if spent <= 0 or not calls:
        return None
    e = run.mix["engine"]
    rows = {i: {"decode": s["decode_rows"], "prefill": s["prefill_rows"],
                "slots": e["num_slots"],
                "prefill_rows": e["num_slots"] * e["prefill_chunk"],
                "top_k": run.model.get("top_k", 0)}
            for i, s in enumerate(run.steps)}
    return 100.0 * calls_floor_s(calls, run.kept["shapes"], rows) / spent

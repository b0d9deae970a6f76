"""The card's peaks, the floor time of a bitmap product and the model
FLOP counts the utilisation metrics divide by.

The floor of a product is the same work whatever implements it: kept
values at 2 bytes (the kernel rounds each value to X's bf16 before the
product), one bit of position per weight element, X read once and Y
written once in bf16, and 2·rows·kept operations, rows being those the
product needs (the slots that decode, the prompt tokens a prefill call
carries, each routed token once per expert it chose).  The floor time
is the larger of bytes over the bandwidth and operations over the bf16
peak.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

# NVIDIA H100 SXM data sheet, dense bf16 without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
ACT_BYTES = 2          # bf16 activations
VALUE_BYTES = 2        # a kept value as the product uses it


def product_floor_s(rows: int, k: int, n: int, kept: float,
                    groups: int = 1) -> float:
    """Least seconds of Y = X·W for a bitmap W of ``groups`` (K, N)
    weights holding ``kept`` values in all, ``rows`` rows of X in all
    (for a grouped product, summed over the groups)."""
    moved = (VALUE_BYTES * kept + groups * k * n / 8
             + ACT_BYTES * rows * (k + n))
    ops = 2.0 * rows * kept / groups
    return max(moved / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S)


def calls_floor_s(calls: Iterable[Dict], kept: Dict[str, Sequence[float]],
                  rows: Dict[int, Dict[str, int]]) -> float:
    """Floor seconds of recorded products.

    ``calls``: one dict per product, {"step", "grouped", "m", "k", "n",
    "g"}; ``kept``: the kept counts of the weights of each shape, keyed
    ``shape_key``; ``rows``: per step, the rows the products needed,
    {"decode": slots that decoded, "prefill": prompt tokens carried,
    "slots": the decode batch, "prefill_rows": a prefill call's rows,
    "top_k": experts per token}.  A product whose rows are the decode
    batch counts the decoding slots, one whose rows are a prefill call's
    counts the prompt tokens; a grouped one counts each token once per
    expert chosen."""
    total = 0.0
    for c in calls:
        r = rows[c["step"]]
        if c["grouped"]:
            tokens = (r["decode"] if c["m"] == r["slots"]
                      else r["prefill"])
            need = tokens * r["top_k"]
        else:
            need = (r["decode"] if c["m"] == r["slots"]
                    else r["prefill"] if c["m"] == r["prefill_rows"]
                    else c["m"])
        ks = kept[shape_key(c["g"], c["k"], c["n"])]
        total += product_floor_s(need, c["k"], c["n"], sum(ks) / len(ks),
                                 c["g"])
    return total


def shape_key(g: int, k: int, n: int) -> str:
    return f"{g}x{k}x{n}"


def train_step_flops(params: int, layers: int, heads: int, head_dim: int,
                     batch: int, seq: int) -> float:
    """6·N·T for the parameter products plus 12·L·H·hd·S·T for the
    attention scores and values at full S, forward and backward; the
    recompute of checkpointing is not counted."""
    t = batch * seq
    return 6.0 * params * t + 12.0 * layers * heads * head_dim * seq * t

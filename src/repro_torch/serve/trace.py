"""Arrival traces for the serving benchmark.

Arrival offsets are measured in *decode steps*, not wall seconds, so a
trace schedules identically on any host — the scheduler's behaviour under
load is deterministic and testable while wall-clock latencies are still
measured for reporting.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def poisson_trace(n_requests: int, rate: float, seed: int = 0,
                  prompt_len: Tuple[int, int] = (1, 4),
                  max_new: Tuple[int, int] = (8, 24),
                  vocab_size: int = 256) -> List[dict]:
    """Seeded Poisson arrival process: exponential inter-arrival gaps with
    mean ``1/rate`` decode steps; prompts and budgets drawn uniformly."""
    assert rate > 0
    r = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n_requests):
        t += float(r.exponential(1.0 / rate))
        plen = int(r.integers(prompt_len[0], prompt_len[1], endpoint=True))
        out.append({
            "prompt": [int(x) for x in r.integers(0, vocab_size, plen)],
            "max_new_tokens": int(r.integers(max_new[0], max_new[1],
                                             endpoint=True)),
            "arrival": t,
        })
    return out


def percentiles(values: Sequence[float], qs=(50, 99)) -> dict:
    if not values:
        return {f"p{q}": float("nan") for q in qs}
    arr = np.asarray(values, np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


class RollingStat:
    """Streaming latency aggregate: exact count/mean plus a bounded
    reservoir for percentiles.

    The engine folds each request's latencies in at retire time instead
    of rescanning its (now bounded) request history on every
    ``report()`` call.  Up to ``cap`` samples the reservoir holds every
    value, so short-trace percentiles are *identical* to the old
    full-scan ``percentiles()``; past ``cap`` it degrades to a
    uniform-without-replacement sample (Vitter's algorithm R) with a
    seeded RNG, so reports stay deterministic for a given trace.
    """

    def __init__(self, cap: int = 2048, seed: int = 0):
        assert cap >= 1
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self._sample: List[float] = []
        self._rng = np.random.default_rng(seed)

    def add(self, value) -> None:
        if value is None:
            return
        v = float(value)
        self.count += 1
        self.total += v
        if len(self._sample) < self.cap:
            self._sample.append(v)
        else:
            j = int(self._rng.integers(self.count))
            if j < self.cap:
                self._sample[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentiles(self, qs=(50, 99)) -> dict:
        return percentiles(self._sample, qs)

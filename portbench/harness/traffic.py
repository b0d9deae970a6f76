"""The one generator of every traffic mix: a mix is a JSON file of
parameters (``portbench/traffic/<mix>.json``), read here.

Every seed gets the same work: the sizes (prompt lengths, positions,
budgets) and the arrival gaps are drawn once from the mix's own
``shape_seed`` and dealt out in an order drawn from the run's seed; the
token ids and sampling seeds come from the run's seed.  Arrivals are in
wall seconds from the window's start.

Serving mixes: ``loop`` "closed" (``sessions`` requests whose caches
set-up builds, then ``backlog`` more of the same shape that take the
slots that free) or "open" (``rate_per_s`` · seconds Poisson arrivals
spread over the window).  Training mixes: ``batch`` rows of
``seq_len`` tokens per step, a marked-Zipf stream (odd positions copy
their predecessor), the targets the next token, the last masked.
A closed mix may give each session's ``position`` (the prompt and the
tokens it already generated, ingested as one prompt) in place of a
``prompt_len``.  Any serving mix may add ``prefix`` ({"groups", "len":
a length spec}): each request's prompt then starts with one of
``groups`` shared prefixes (its own ``prompt_len`` tokens follow), and
``tokens`` ({"dist": "band", "bands", "width", "zipf_a"}): each
request's ids then lie in one of ``bands`` bands of ``width`` ids (a
topic), band j chosen in proportion to 1/(j+1)^zipf_a.  Without
``tokens`` the ids are uniform over the vocabulary.  A mix that needs
more than these parameters brings its own generator
(``portbench/traffic/<mix>.py``, ``harness.manifest.generator``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng(*words: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(w) % 2**64 for w in words]))


def draw(spec: Dict, n: int, r: np.random.Generator) -> np.ndarray:
    """n integers from a length spec: {"dist": "fixed", "value"},
    {"dist": "uniform", "lo", "hi"} or {"dist": "loguniform", "lo",
    "hi"}, bounds included."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "uniform":
        return r.integers(lo, hi, size=n, endpoint=True)
    if spec["dist"] == "loguniform":
        x = np.exp(r.uniform(np.log(lo), np.log(hi + 1), size=n))
        return np.clip(np.floor(x).astype(np.int64), lo, hi)
    raise ValueError(f"dist {spec['dist']!r}")


def serve_requests(mix: Dict, vocab: int, seed: int,
                   seconds: float) -> List[Dict]:
    """The requests of one run, in arrival order: {"prompt",
    "max_new_tokens", "due_s", "greedy", "temperature", "top_k",
    "seed", "session"}.  A closed loop's requests are all due at 0,
    the first ``sessions`` of them the sessions set-up builds."""
    shape = rng(mix["shape_seed"])
    order = rng(seed, 1)
    toks = rng(seed, 2)
    if mix["loop"] == "closed":
        n = mix["sessions"] + mix["backlog"]
        due = np.zeros(n)
    else:
        n = max(1, int(round(mix["rate_per_s"] * seconds)))
        gaps = shape.exponential(1.0, size=n + 1)[order.permutation(n + 1)]
        due = seconds * np.cumsum(gaps)[:n] / gaps.sum()
    ingest = draw(mix["position"] if "position" in mix
                  else mix["prompt_len"], n, shape)
    new = draw(mix["new_tokens"], n, shape)
    group = band = np.zeros(n, np.int64)
    if "prefix" in mix:
        groups = int(mix["prefix"]["groups"])
        pre_len = draw(mix["prefix"]["len"], groups, shape)
        group = shape.integers(0, groups, n)
        pre = rng(seed, 5)
        prefixes = [[int(t) for t in pre.integers(0, vocab, k)]
                    for k in pre_len]
    lo, width = np.zeros(1, np.int64), vocab
    if "tokens" in mix and mix["tokens"]["dist"] != "uniform":
        t = mix["tokens"]
        if t["dist"] != "band":
            raise ValueError(f"tokens dist {t['dist']!r}")
        width = int(t["width"])
        w = 1.0 / (1.0 + np.arange(int(t["bands"]))) ** t.get("zipf_a", 0.0)
        band = shape.choice(len(w), size=n, p=w / w.sum())
        lo = rng(seed, 6).integers(0, vocab - width + 1, len(w))
    greedy = np.arange(n) < int(round(mix["greedy_share"] * n))
    perm = order.permutation(n)
    ingest, new, greedy = ingest[perm], new[perm], greedy[perm]
    group, band = group[perm], band[perm]
    out = []
    for i in range(n):
        b = int(lo[band[i]])
        own = [int(t) for t in toks.integers(b, b + width, ingest[i])]
        out.append({
            "prompt": (prefixes[group[i]] + own if "prefix" in mix
                       else own),
            "max_new_tokens": int(new[i]),
            "due_s": float(due[i]),
            "greedy": bool(greedy[i]),
            "temperature": 0.0 if greedy[i] else float(mix["temperature"]),
            "top_k": None if greedy[i] else int(mix["top_k"]),
            "seed": int(toks.integers(0, 2**31 - 1)),
            "session": mix["loop"] == "closed" and i < mix["sessions"],
        })
    return out


def train_batch(mix: Dict, vocab: int, seed: int, step: int):
    """(tokens, targets) int64 numpy arrays (B, S) of step ``step``."""
    r = rng(seed, 3, step)
    b, s = mix["batch"], mix["seq_len"]
    base = r.zipf(mix["zipf_a"], size=(b, s)).astype(np.int64) % vocab
    base[:, 1::2] = base[:, 0::2][:, :base[:, 1::2].shape[1]]
    targets = np.concatenate([base[:, 1:], np.full((b, 1), -1, np.int64)],
                             axis=1)
    return base, targets

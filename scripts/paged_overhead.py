#!/usr/bin/env python3
"""Paged against contiguous KV on the card: what the paged branch costs a
served olmo-1b decode step.

Run from the root of the repository on a machine with one NVIDIA H100
and the CUDA toolkit:

    python3 scripts/paged_overhead.py [--rounds 3]

Builds full-width olmo-1b at sparsity 0.5 (seeded random weights) as two
engines on the same packed weights, one on the contiguous cache and one
on paged KV (pages of 16 tokens, the default pool), and serves the same
seeded 8-request trace (``chip_smoke.py`` phase 3's) on each in turns,
contiguous, paged, paged, contiguous, ``--rounds`` times.  For each run
it prints tok/s, the wall per decode step, and on the paged engine the
host time spent in the allocator per decode step (``ensure`` /
``ensure_range`` and the table upload, timed around the calls).  Each
run's tokens must equal the first contiguous run's.  Then it profiles
six full-batch decode steps of each engine (``torch.profiler``): wall,
device busy time and the number of device kernels per step.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def timed_allocator(kv) -> list:
    """Wrap the allocator's per-step calls with a host timer; returns the
    list the seconds accumulate in (one entry per call)."""
    spent = []
    for name in ("ensure", "ensure_range", "tables"):
        fn = getattr(kv, name)

        def wrapper(*args, _fn=fn, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                spent.append(time.perf_counter() - t0)

        setattr(kv, name, wrapper)
    return spent


def profile(eng, steps: int = 6) -> str:
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    for i in range(eng.num_slots):
        eng.submit([1 + i], max_new_tokens=steps + 4, arrival=eng._steps)
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    kernels = sum(e.count for e in dev)
    return (f"{1e3 * wall / steps:.2f} ms per step, device busy "
            f"{1e3 * busy / steps:.2f} ms (idle "
            f"{100 * (1 - busy / wall):.1f}%), {kernels / steps:.0f} device "
            f"kernels per step")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    from chip_smoke import assert_no_dense_copy
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine, poisson_trace
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__}")
    cfg = get_config("olmo-1b")
    cont = ServeEngine(cfg, num_slots=4, max_len=256, sparsity=0.5, seed=0,
                       device="cuda")
    paged = ServeEngine(cfg, num_slots=4, max_len=256, params=cont.params,
                        head_sparsity=cont.head_sparsity, paged=True,
                        page_len=16, device="cuda")
    for eng in (cont, paged):
        assert_no_dense_copy(eng)
        eng.warmup()
    spent = timed_allocator(paged.kv)
    trace = poisson_trace(8, rate=0.5, seed=0, vocab_size=cfg.vocab_size,
                          prompt_len=(1, 4), max_new=(8, 24))
    want = None
    rows = {"contiguous": [], "paged": []}
    for _ in range(args.rounds):
        for label in ("contiguous", "paged", "paged", "contiguous"):
            eng = paged if label == "paged" else cont
            steps0, spent0 = eng.decode_steps, len(spent)
            t_alloc0 = sum(spent)
            torch.cuda.synchronize()
            reqs = [eng.submit(**{**spec,
                                  "arrival": spec["arrival"] + eng._steps})
                    for spec in trace]
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tokens = [r.tokens for r in reqs]
            want = want or tokens
            assert tokens == want, f"{label} run served other tokens"
            steps = eng.decode_steps - steps0
            gen = sum(len(t) for t in tokens)
            alloc = (f" | allocator "
                     f"{1e3 * (sum(spent) - t_alloc0) / steps:.3f} ms per "
                     f"step over {len(spent) - spent0} calls"
                     if eng is paged else "")
            rows[label].append((gen / wall, 1e3 * wall / steps))
            print(f"{label}: {gen} tokens in {wall:.3f}s over {steps} decode "
                  f"steps | {gen / wall:.1f} tok/s | "
                  f"{1e3 * wall / steps:.2f} ms per step{alloc}")
    for label, vals in rows.items():
        print(f"{label} median over {len(vals)} runs: "
              f"{statistics.median(v[0] for v in vals):.1f} tok/s, "
              f"{statistics.median(v[1] for v in vals):.2f} ms per step "
              f"(range {min(v[1] for v in vals):.2f}-"
              f"{max(v[1] for v in vals):.2f})")
    pg = paged.report()["paging"]
    print(f"paged pool: peak {pg['pages_peak']} of {pg['pages_total']} pages, "
          f"reserved KV {pg['reserved_kv_bytes'] / 2**20:.1f} MiB vs "
          f"contiguous {pg['contiguous_kv_bytes'] / 2**20:.1f} MiB")
    for label, eng in (("contiguous", cont), ("paged", paged)):
        print(f"profiler {label}: {profile(eng)}")
    print(f"paged_overhead: done on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Card and build: prints the card's name and power limit, then builds
   the ``bitmap_spmm`` CUDA kernel from ``src/repro_torch/kernels/csrc``
   for ``sm_90a`` (registers, shared memory and spills from ptxas).
2. Kernel against its plain version at every olmo-1b decode shape
   (K×N of the projections and the LM head), rows M in {1, 4, 8, 130},
   weights pruned to {0, 0.5, 0.75, 0.95}, float32 and bfloat16 X:
   atol 2e-3·√K (float32) / 2e-2·√K (bfloat16), rtol 1e-2.
3. Engine: ``ServeEngine`` on the full olmo-1b configuration (16 layers,
   full widths, random weights from a seeded generator) at sparsity 0.5,
   4 slots, serving a seeded Poisson trace of 8 requests.  Checks that
   every request is served its whole budget, that the kernel launched
   113 times per decode step (7 projections × 16 layers + the head),
   that no dense copy of a packed weight exists on the card, and that
   one decode step's logits through the kernel agree with the same step
   through the plain version.  The same trace is then served by the
   dense-dispatch engine (``stream_weights=False``) as a yardstick.
4. Kernel timing at the four decode shapes (M = 4), and of all 113
   launches of one decode step, with CUDA events: the kernel, its bound
   (the larger of its bytes over 3.35 TB/s and its operations over
   989 TFLOP/s), its plain version, and ``torch.matmul`` with the dense
   bfloat16 weight as the library yardstick.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core peak, same source
OLMO_SHAPES = (("qkvo", 2048, 2048), ("gate_up", 2048, 8192),
               ("down", 8192, 2048), ("head", 2048, 50304))
SPARSITIES = (0.0, 0.5, 0.75, 0.95)
ROWS = (1, 4, 8, 130)
ATOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
SOURCE = "src/repro_torch/kernels/csrc/bitmap_spmm.cu"
REPLACES = "src/repro/kernels/bitmap_spmm.py:74"


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` eager runs, CUDA
    events, after one warm-up run (host launch cost included)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()``'s launches replayed as one CUDA
    graph: device time, without the host's per-launch cost."""
    fn()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def call_bound(x: torch.Tensor, bw):
    """(bytes, operations) one call must move and do.  Bytes are the
    kernel's ``hbm_traffic_model`` with each term counted once: X read
    once (the model re-reads it per column tile), the compressed weight
    (bitmap + values + row starts) once, the output written once.
    Operations: two per multiply-add over this weight's actual
    non-zeros."""
    from repro_torch.kernels.bitmap_spmm import hbm_traffic_model
    m = x.shape[0]
    c = hbm_traffic_model(tuple(x.shape), bw,
                          itemsize=x.element_size())["components"]
    moved = (c["x_bytes"] // c["col_blocks"] + c["out_bytes"]
             + c["w_sparse_bytes"] // c["row_blocks"])
    return moved, 2 * m * bw.nnz


def bound_ms(moved: float, ops: float):
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_and_build() -> str:
    from repro_torch.kernels import bitmap_spmm
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) | "
          f"device {torch.cuda.get_device_name(0)} | count "
          f"{torch.cuda.device_count()}")
    built = bitmap_spmm.build()
    print(f"build: {built.path.relative_to(ROOT)} in {built.seconds:.1f}s"
          if built.seconds else f"build: {built.path.name} already built")
    for line in built.log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  {line.strip()}")
    return smi


def kernel_against_plain(device, gen, shapes=OLMO_SHAPES, rows=ROWS,
                         sparsities=SPARSITIES) -> float:
    """Phase 2; returns the largest absolute difference seen."""
    from repro_torch.kernels import LAUNCHES, ops
    from repro_torch.serve.packed import choose_block
    from repro_torch.sparse import pack_bitmap, per_tensor_prune
    from repro_torch.sparse.format import unpack_bitmap
    worst = 0.0
    for name, k, n in shapes:
        block = choose_block(k, n)
        base = torch.randn(k, n, generator=gen, device=device)
        for s in sparsities:
            bw = pack_bitmap(per_tensor_prune(base, s), block=block)
            plain_w = dataclasses.replace(bw, dense_cache=unpack_bitmap(bw))
            errs = {}
            for m in rows:
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn(m, k, generator=gen, device=device).to(dt)
                    out = ops.bitmap_spmm(x, bw, impl="cuda")
                    ref = ops.bitmap_spmm(x, plain_w, impl="torch")
                    sync()
                    assert out.shape == ref.shape == (m, n), out.shape
                    err = (out.float() - ref.float()).abs().max().item()
                    if not torch.allclose(out.float(), ref.float(),
                                          atol=ATOL[dt] * math.sqrt(k),
                                          rtol=1e-2):
                        raise AssertionError(
                            f"bitmap_spmm {name} K={k} N={n} M={m} {dt} "
                            f"sparsity {s}: max |kernel - plain| {err}")
                    errs[dt] = max(errs.get(dt, 0.0), err)
                    worst = max(worst, err)
            print(f"  {name} K={k} N={n} block {block} sparsity {s}: "
                  f"budget {bw.budget}, max |kernel - plain| "
                  f"f32 {errs[torch.float32]:.3g} "
                  f"bf16 {errs[torch.bfloat16]:.3g} over M={list(rows)}")
            del bw, plain_w
    print(f"kernels: bitmap_spmm launches {LAUNCHES['bitmap_spmm']} "
          f"(comparison phase, max |kernel - plain| {worst:.3g})")
    return worst


def assert_no_dense_copy(eng) -> None:
    assert eng.lm_weight.dense_cache is None
    assert all(bw.dense_cache is None for _, bw in eng.packed.leaves())
    assert all(bw.values.is_cuda for _, bw in eng.packed.leaves())


def serve(eng, trace, label: str) -> dict:
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import RequestState
    eng.warmup()
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reqs = [eng.submit(**spec) for spec in trace]
    rep = eng.run()
    rep["launches"] = LAUNCHES["bitmap_spmm"]
    for r in reqs:
        assert r.state is RequestState.DONE, (r.rid, r.state)
        assert len(r.tokens) == r.max_new_tokens, (r.rid, len(r.tokens))
    lat = rep["latency_s"]
    print(f"{label}: {rep['requests']} requests / {rep['generated_tokens']} "
          f"tokens in {rep['wall_s']:.3f}s over {eng.decode_steps} decode "
          f"steps | {rep['tok_per_s']:.1f} tok/s | latency p50 "
          f"{lat['p50'] * 1e3:.1f}ms p99 {lat['p99'] * 1e3:.1f}ms | "
          f"max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
          f"kernel launches {rep['launches']}")
    return rep


def profile_steps(eng, steps: int = 6) -> None:
    """Device busy share of full-batch decode steps (torch.profiler):
    kernel time summed per name over the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(eng.num_slots):
        eng.submit([1 + i], max_new_tokens=steps + 4, arrival=eng._steps)
    for _ in range(2):
        eng.step()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    kernels = [(e.key, e.self_device_time_total)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t in kernels)
    if not busy_us:
        print("profiler: no device time seen; idle share not measured")
        return
    spmm_us = sum(t for k, t in kernels
                  if "bitmap_spmm" in k or "sum_splits" in k)
    top = sorted(kernels, key=lambda kt: -kt[1])[:4]
    print(f"profiler, {steps} decode steps: {wall_us / steps / 1e3:.2f} ms "
          f"per step, device busy {busy_us / steps / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f}%; idle "
          f"{100 * (1 - busy_us / wall_us):.1f}%), bitmap_spmm "
          f"{spmm_us / steps / 1e3:.2f} ms per step | top: "
          + ", ".join(f"{k[:40]} {t / steps / 1e3:.2f} ms" for k, t in top))


def engine_phase(cfg, device, gen, trace_len: int = 8):
    """Phase 3; returns the packed engine and its main-path launch
    counts: total, per decode step, and decode steps."""
    from repro_torch.models.model import decode_step
    from repro_torch.serve import ServeEngine, poisson_trace
    eng = ServeEngine(cfg, num_slots=4, max_len=256, sparsity=0.5, seed=0,
                      device=device)
    ws = eng.weight_stream_report()
    print(f"engine {cfg.name}: init {eng.init_s:.2f}s, prune + pack "
          f"{eng.pack_s:.2f}s | weight sparsity {eng.weight_sparsity:.4f}"
          f" | head compression {eng.head_compression:.3f}x | modeled "
          f"weight bytes per step {ws['sparse_bytes_per_step'] / 1e9:.3f}"
          f" GB packed vs {ws['dense_bytes_per_step'] / 1e9:.3f} GB dense")
    assert_no_dense_copy(eng)
    per_step = cfg.num_periods * len(eng.packed.packed_entries) + 1
    trace = poisson_trace(trace_len, rate=0.5, seed=0,
                          vocab_size=cfg.vocab_size, prompt_len=(1, 4),
                          max_new=(8, 24))
    rep = serve(eng, trace, "packed (bitmap_spmm) engine")
    launches, steps = rep["launches"], eng.decode_steps
    assert launches == per_step * steps, (launches, per_step, steps)
    print(f"main path: {launches} bitmap_spmm launches = {per_step} per "
          f"decode step x {steps} steps")

    # one decode step, through the kernel and through the plain version
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                        device=device)
    pos = torch.tensor([3, 17, 64, 200], device=device)
    out = {}
    for impl in (None, "torch"):
        cache = {b: {k: t.clone() for k, t in leaf.items()}
                 for b, leaf in eng.kv.cache.items()}
        out[impl], _ = decode_step(eng.params, cache, cfg, tok, pos,
                                   lm_weight=eng.lm_weight,
                                   packed=eng.packed.blocks, lm_impl=impl)
    sync()
    got, want = out[None], out["torch"]
    assert got.shape == (4, cfg.vocab_size) and bool(
        torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    # a quarter of the logits' own spread: a projection or head wrong by
    # a typical logit fails it (bf16 rounding left 0.08 at a spread ~0.9)
    scale = want.std().item()
    tol = 0.25 * scale
    assert err <= tol, (err, tol)
    # the argmax must agree wherever the plain step's top-2 margin is
    # wider than twice the difference seen: a closer tie may flip on
    # rounding alone
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = got.argmax(-1) == want.argmax(-1)
    decided = margin > 2 * err
    assert bool(same[decided].all()), (same.tolist(), margin.tolist())
    print(f"decode-step logits, kernel vs plain: max |diff| {err:.4g} "
          f"(atol {tol:.3g} = 0.25 x logit std {scale:.3g}) | argmax "
          f"agreement {same.float().mean().item():.2f}, required on "
          f"{int(decided.sum())}/{len(same)} rows (top-2 margins "
          f"{', '.join(f'{v:.3g}' for v in margin.tolist())})")
    profile_steps(eng)

    dense = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                        stream_weights=False, bitmap_head=False,
                        device=device)
    drep = serve(dense, trace, "dense-dispatch engine (yardstick)")
    assert drep["launches"] == 0
    print(f"tok/s packed {rep['tok_per_s']:.1f} vs dense-dispatch "
          f"{drep['tok_per_s']:.1f}")
    del dense
    return eng, {"launches": launches, "launches_per_step": per_step,
                 "decode_steps": steps}


def timing_phase(eng, device, gen, m: int = 4):
    """Phase 4; returns (ms, plain_ms, bound_ms, bound_by, library_ms)
    for all launches of one decode step."""
    from repro_torch.kernels import ops
    from repro_torch.sparse.format import unpack_bitmap
    cfg = eng.cfg
    blk = eng.packed.blocks["b0"]
    attn, mlp = blk["attn"], blk["mlp"]
    periods = range(cfg.num_periods)
    groups = {
        "qkvo": [attn[n].period(p) for p in periods
                 for n in ("wq", "wk", "wv", "wo")],
        "gate_up": [mlp[n].period(p) for p in periods
                    for n in ("w_gate", "w_up")],
        "down": [mlp["w_down"].period(p) for p in periods],
        "head": [eng.lm_weight],
    }

    def xs(k):
        return torch.randn(m, k, generator=gen, device=device,
                           dtype=torch.bfloat16)

    for name, ws in groups.items():
        x = xs(ws[0].shape[0])
        dense = [unpack_bitmap(w).to(torch.bfloat16) for w in ws]
        # cycling through every layer's copy keeps each call's weight out
        # of the 50 MB L2, as in a decode step
        t_k = graph_ms(lambda: [ops.bitmap_spmm(x, w, impl="cuda")
                                for w in ws], 20) / len(ws)
        t_e = time_ms(lambda: [ops.bitmap_spmm(x, w, impl="cuda")
                               for w in ws], 10) / len(ws)
        few = ws[:4]
        t_p = time_ms(lambda: [ops.bitmap_spmm(x, w, impl="torch")
                               for w in few], 2) / len(few)
        t_l = graph_ms(lambda: [torch.matmul(x, d) for d in dense],
                       20) / len(ws)
        moved = sum(call_bound(x, w)[0] for w in ws) / len(ws)
        ops_ = sum(call_bound(x, w)[1] for w in ws) / len(ws)
        b_ms, by = bound_ms(moved, ops_)
        k, n = ws[0].shape
        print(f"  {name} K={k} N={n} M={m} ({len(ws)} weights): kernel "
              f"{t_k:.4f} ms | bound {b_ms:.4f} ms ({by}) = "
              f"{100 * b_ms / t_k:.1f}% | {moved / t_k / 1e6:.0f} GB/s | "
              f"eager (host launch included) {t_e:.4f} ms | plain "
              f"{t_p:.4f} ms | torch.matmul dense bf16 {t_l:.4f} ms")
        del dense

    seq = []
    x_d, x_f = xs(cfg.d_model), xs(cfg.d_ff)
    for p in periods:
        seq += [(x_d, attn[n].period(p)) for n in ("wq", "wk", "wv", "wo")]
        seq += [(x_d, mlp["w_gate"].period(p)), (x_d, mlp["w_up"].period(p)),
                (x_f, mlp["w_down"].period(p))]
    seq.append((x_d, eng.lm_weight))
    moved = sum(call_bound(x, w)[0] for x, w in seq)
    ops_ = sum(call_bound(x, w)[1] for x, w in seq)
    b_ms, by = bound_ms(moved, ops_)
    t_k = graph_ms(lambda: [ops.bitmap_spmm(x, w, impl="cuda")
                            for x, w in seq], 20)
    t_e = time_ms(lambda: [ops.bitmap_spmm(x, w, impl="cuda")
                           for x, w in seq], 10)
    t_p = time_ms(lambda: [ops.bitmap_spmm(x, w, impl="torch")
                           for x, w in seq], 1)
    dense = [unpack_bitmap(w).to(torch.bfloat16) for _, w in seq]
    t_l = graph_ms(lambda: [torch.matmul(x, d) for (x, _), d in
                            zip(seq, dense)], 20)
    del dense
    print(f"one decode step, {len(seq)} launches at M={m}: kernel "
          f"{t_k:.3f} ms (CUDA graph; eager {t_e:.3f} ms) | bound "
          f"{b_ms:.3f} ms ({by}; {moved / 1e9:.3f} GB) = "
          f"{100 * b_ms / t_k:.1f}% | plain {t_p:.3f} ms | "
          f"torch.matmul dense bf16 {t_l:.3f} ms (CUDA graph)")
    return t_k, t_p, b_ms, by, t_l


def run(cfg, device, gen, shapes=OLMO_SHAPES, trace_len: int = 8) -> dict:
    """Phases 2-4; returns the kernels record.  ``launches`` counts the
    main-path run (``launches_per_step`` x ``decode_steps``); ``ms``,
    ``plain_ms``, ``bound_ms`` and ``library_ms`` are one decode step's
    ``launches_per_step`` calls at M = 4 (``ms_scope``)."""
    worst = kernel_against_plain(device, gen, shapes=shapes)
    eng, counts = engine_phase(cfg, device, gen, trace_len)
    ms, plain_ms, b_ms, by, lib_ms = timing_phase(eng, device, gen)
    return {"kernels": [{
        "name": "bitmap_spmm", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, **counts, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": lib_ms,
        "ms_scope": f"one decode step: {counts['launches_per_step']} "
                    f"launches at M=4"}]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = card_and_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = run(get_config("olmo-1b"), torch.device("cuda"), gen)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s"
          f" on {smi} (the kernels line: launches over the main-path run; "
          f"times per decode step)")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Card and build: prints the card's name and power limit, then builds
   the CUDA kernels from ``src/repro_torch/kernels/csrc`` for ``sm_90a``
   (one library, two entry points: ``bitmap_spmm`` and
   ``bitmap_spmm_grouped``; registers, shared memory and spills from
   ptxas).
2. Kernels against their plain versions: ``bitmap_spmm`` (K1) at every
   olmo-1b decode shape (rows M in {1, 4, 8, 130}, weights pruned to
   {0, 0.5, 0.75, 0.95}) and at granite-moe-3b-a800m's attention and
   router shapes (the router's 40-wide output: BN = 40), and
   ``bitmap_spmm_grouped`` (K1g) at granite's 40-expert stacks, rows M
   in {1, 4, 64, 130}, weights pruned to {0, 0.5, 0.95}; float32 and
   bfloat16 X; atol 2e-3·√K (float32) / 2e-2·√K (bfloat16), rtol 1e-2.
3. olmo-1b: ``ServeEngine`` on the full configuration (16 layers, full
   widths, seeded random weights) at sparsity 0.5, 4 slots, serving a
   seeded Poisson trace of 8 requests: every request served its whole
   budget, K1 launched 113 times per decode step (7 projections × 16
   layers + the head), no dense copy of a packed weight on the card, and
   one decode step's logits through the kernel agreeing with the plain
   version; the dense-dispatch engine serves the same trace as a
   yardstick.  Then K1 is timed at the four decode shapes (M = 4) and
   over one decode step's 113 launches.
4. granite-moe-3b-a800m: ``ServeEngine`` on the full configuration (32
   layers, 40 experts top-8, full widths, seeded random weights) at
   sparsity 0.5, 4 slots, ``max_len`` 256, serving 8 requests with
   prompts of 8-32 tokens once by the prompt walk (``prefill_chunk=0``)
   and once by chunked prefill (``prefill_chunk=16``).  Each run: every
   request served its whole budget, exactly 160 K1 launches (wq, wk,
   wv, wo, router × 32) and 96 K1g launches (w_gate, w_up, w_down × 32)
   per decode step and per prefill call, no dense copy of a packed
   weight; one decode step's logits and one prefill call's hidden
   states through the kernels agree with the plain versions.  The
   dense-dispatch engine serves the same trace.  Then K1g is timed over
   all 32 layers' expert stacks at M = 4, K1 over granite's 160
   projections, a whole decode step's 256 launches, and the card's idle
   share under ``torch.profiler``.
5. Library yardsticks for the kernels still to port, called nowhere in
   the port: ``scaled_dot_product_attention`` at olmo-1b's full-sequence
   shape (K2) and ``torch.matmul`` at olmo-1b's gate/up decode shape (K3,
   K4).

Bounds are the larger of the bytes a call must move over 3.35 TB/s and
its operations over 989 TFLOP/s (bf16), with this run's non-zeros.  The
line before the last is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside the
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
GRANITE_SHAPES = (("q_o", 1536, 1536), ("k_v", 1536, 512),
                  ("router", 1536, 40))
GRANITE_EXPERT_SHAPES = (("gate_up", 1536, 512), ("down", 512, 1536))
SPARSITIES = (0.0, 0.5, 0.75, 0.95)
ROWS = (1, 4, 8, 130)
GRANITE_SPARSITIES = (0.0, 0.5, 0.95)
GRANITE_ROWS = (1, 4, 64, 130)
ATOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
SOURCE = "src/repro_torch/kernels/csrc/bitmap_spmm.cu"
REPLACES = {"bitmap_spmm": "src/repro/kernels/bitmap_spmm.py:74",
            "bitmap_spmm_grouped": "src/repro/kernels/bitmap_spmm.py:167"}


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
    (bitmap + values + row starts, every group of a grouped call) once,
    the output written once.  Operations: two per multiply-add over this
    weight's actual non-zeros, for each of the M rows of its group."""
    from repro_torch.kernels.bitmap_spmm import hbm_traffic_model
    m = x.shape[-2]
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
        if "Compiling entry" in line:
            print(f"  {line.split(chr(39))[1][:90]}")
        elif "Used" in line or "spill" in line:
            print(f"    {line.strip()}")
    lib = bitmap_spmm._library()
    print(f"entry points: {lib.bitmap_spmm_launch.__name__}, "
          f"{lib.bitmap_spmm_grouped_launch.__name__}")
    return smi


def _compare(name, out, ref, k, dt) -> float:
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(),
                          atol=ATOL[dt] * math.sqrt(k), rtol=1e-2):
        raise AssertionError(f"{name} {dt}: max |kernel - plain| {err}")
    return err


def kernel_against_plain(device, gen, shapes, rows, sparsities,
                         groups: int = 0) -> float:
    """Phase 2 for one kernel: K1 (``groups`` 0) or K1g over ``groups``
    experts.  Returns the largest absolute difference seen."""
    from repro_torch.kernels import ops
    from repro_torch.serve.packed import choose_block
    from repro_torch.sparse import (pack_bitmap, pack_bitmap_experts,
                                    per_tensor_prune)
    from repro_torch.sparse.format import unpack_bitmap_stacked
    worst = 0.0
    kernel = ops.bitmap_spmm_grouped if groups else ops.bitmap_spmm
    lead = (groups,) if groups else ()
    for name, k, n in shapes:
        block = choose_block(k, n)
        base = torch.randn(*lead, k, n, generator=gen, device=device)
        for s in sparsities:
            w = per_tensor_prune(base, s)
            bw = (pack_bitmap_experts(w[None], block=block).period(0)
                  if groups else pack_bitmap(w, block=block))
            plain_w = dataclasses.replace(
                bw, dense_cache=unpack_bitmap_stacked(bw))
            errs = {}
            for m in rows:
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn(*lead, m, k, generator=gen,
                                    device=device).to(dt)
                    out = kernel(x, bw, impl="cuda")
                    ref = kernel(x, plain_w, impl="torch")
                    sync()
                    assert out.shape == (*lead, m, n), out.shape
                    err = _compare(f"{name} K={k} N={n} M={m} sparsity {s}",
                                   out, ref, k, dt)
                    errs[dt] = max(errs.get(dt, 0.0), err)
                    worst = max(worst, err)
            print(f"  {name} {'G=%d ' % groups if groups else ''}K={k} "
                  f"N={n} block {block} sparsity {s}: budget {bw.budget}, "
                  f"max |kernel - plain| f32 {errs[torch.float32]:.3g} "
                  f"bf16 {errs[torch.bfloat16]:.3g} over M={list(rows)}")
            del bw, plain_w, w
    return worst


def assert_no_dense_copy(eng) -> None:
    assert eng.lm_weight is None or eng.lm_weight.dense_cache is None
    assert all(bw.dense_cache is None for _, bw in eng.packed.leaves())
    assert all(bw.values.is_cuda for _, bw in eng.packed.leaves())


def per_step(eng) -> dict:
    """Kernel launches one decode step (or prefill call) makes: one per
    packed leaf per period, plus the head when it is packed."""
    cfg = eng.cfg
    layouts = [e.layout for e in eng.packed.packed_entries]
    return {"bitmap_spmm": cfg.num_periods * layouts.count("stacked")
            + (eng.lm_weight is not None),
            "bitmap_spmm_grouped": cfg.num_periods * layouts.count("grouped")}


def serve(eng, trace, label: str) -> dict:
    """Serve ``trace`` on a warm engine with the launch counts set to 0
    just before and read just after; returns its report with the
    counts."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import RequestState
    eng.warmup()
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reqs = [eng.submit(**spec) for spec in trace]
    rep = eng.run()
    rep["launches"] = dict(LAUNCHES)
    for r in reqs:
        assert r.state is RequestState.DONE, (r.rid, r.state)
        assert len(r.tokens) == r.max_new_tokens, (r.rid, len(r.tokens))
    lat, ftl = rep["latency_s"], rep["first_token_s"]
    pf = rep["prefill"]
    print(f"{label}: {rep['requests']} requests / {rep['generated_tokens']} "
          f"tokens in {rep['wall_s']:.3f}s over {eng.decode_steps} decode "
          f"steps + {pf['calls']} prefill calls | {rep['tok_per_s']:.1f} "
          f"tok/s | latency p50 {lat['p50'] * 1e3:.1f}ms p99 "
          f"{lat['p99'] * 1e3:.1f}ms | TTFT p50 {ftl['p50'] * 1e3:.1f}ms "
          f"| max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
          f"launches {rep['launches']}")
    return rep


def check_counts(eng, rep, label: str) -> dict:
    """Every kernel of the path ran, exactly its per-step count for each
    decode step and prefill call; returns the path's record."""
    expect = per_step(eng)
    calls = eng.decode_steps + rep["prefill"]["calls"]
    for name, n in expect.items():
        assert rep["launches"][name] == n * calls, (name, rep["launches"],
                                                    expect, calls)
        if n:
            assert rep["launches"][name] > 0, (name, label)
    print(f"main path {label}: {rep['launches']} = {expect} per call x "
          f"({eng.decode_steps} decode steps + {rep['prefill']['calls']} "
          f"prefill calls)")
    return {name: {"path": label, "launches": rep["launches"][name],
                   "launches_per_step": n,
                   "decode_steps": eng.decode_steps,
                   "prefill_calls": rep["prefill"]["calls"]}
            for name, n in expect.items() if n}


def agree(got: torch.Tensor, want: torch.Tensor, label: str,
          argmax: bool = True) -> float:
    """``got`` (kernels) within 0.25 × the plain result's spread of
    ``want`` (plain versions): a product wrong by a typical value fails
    it.  With ``argmax``, rows whose top-2 margin exceeds twice the
    largest difference must agree on the argmax (a closer tie may flip
    on rounding alone)."""
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().std().item()
    tol = 0.25 * scale
    assert err <= tol, (label, err, tol)
    msg = (f"{label}, kernels vs plain: max |diff| {err:.4g} (atol "
           f"{tol:.3g} = 0.25 x std {scale:.3g})")
    if argmax:
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        decided = margin > 2 * err
        assert bool(same[decided].all()), (same.tolist(), margin.tolist())
        msg += (f" | argmax agreement {same.float().mean().item():.2f}, "
                f"required on {int(decided.sum())}/{len(same)} rows (top-2 "
                f"margins {', '.join(f'{v:.3g}' for v in margin.tolist())})")
    print(msg)
    return err


def decode_step_check(eng, gen) -> None:
    """One decode step through the kernels against the same step through
    the plain versions, on copies of the engine's cache."""
    from repro_torch.models.model import decode_step
    cfg, device = eng.cfg, eng.device
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
        del cache
    sync()
    assert out[None].shape == (4, cfg.vocab_size)
    agree(out[None], out["torch"], "decode-step logits")


def prefill_call_check(eng, gen, chunk: int) -> None:
    """One chunked-prefill call (four lanes: two full chunks, a short
    one, a padding lane) through the kernels against the plain versions:
    hidden states, and the logits of the valid rows."""
    from repro_torch.models.model import head_logits, prefill_hidden
    cfg, device = eng.cfg, eng.device
    tok = torch.randint(0, cfg.vocab_size, (4, chunk), generator=gen,
                        device=device)
    pos = torch.tensor([0, chunk, 40, 0], device=device)
    lens = torch.tensor([chunk, chunk, chunk // 2 + 1, 0], device=device)
    out = {}
    for impl in (None, "torch"):
        cache = {b: {k: t.clone() for k, t in leaf.items()}
                 for b, leaf in eng.kv.cache.items()}
        out[impl], _ = prefill_hidden(eng.params, cache, cfg, tok, pos, lens,
                                      packed=eng.packed.blocks, impl=impl)
        del cache
    sync()
    assert out[None].shape == (4, chunk, cfg.d_model)
    agree(out[None], out["torch"], "prefill-call hidden states",
          argmax=False)
    valid = torch.arange(chunk, device=device)[None, :] < lens[:, None]
    logits = {impl: head_logits(eng.params, cfg, h[valid], eng.lm_weight,
                                impl) for impl, h in out.items()}
    agree(logits[None], logits["torch"], "prefill-call logits")


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
    print(f"profiler {eng.cfg.name}, {steps} decode steps: "
          f"{wall_us / steps / 1e3:.2f} ms per step, device busy "
          f"{busy_us / steps / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%;"
          f" idle {100 * (1 - busy_us / wall_us):.1f}%), bitmap_spmm "
          f"kernels {spmm_us / steps / 1e3:.2f} ms per step | top: "
          + ", ".join(f"{k[:40]} {t / steps / 1e3:.2f} ms" for k, t in top))


def olmo_engine_phase(cfg, device, gen, trace_len: int = 8):
    """Phase 3 (serving); returns the packed engine and its path
    record."""
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
    trace = poisson_trace(trace_len, rate=0.5, seed=0,
                          vocab_size=cfg.vocab_size, prompt_len=(1, 4),
                          max_new=(8, 24))
    rep = serve(eng, trace, "packed (bitmap_spmm) engine")
    path = check_counts(eng, rep, f"{cfg.name}, prompt walk")
    decode_step_check(eng, gen)
    profile_steps(eng)

    dense = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                        stream_weights=False, bitmap_head=False,
                        device=device)
    drep = serve(dense, trace, "dense-dispatch engine (yardstick)")
    assert sum(drep["launches"].values()) == 0
    print(f"tok/s packed {rep['tok_per_s']:.1f} vs dense-dispatch "
          f"{drep['tok_per_s']:.1f}")
    del dense
    return eng, path


def olmo_timing_phase(eng, device, gen, m: int = 4):
    """Phase 3 (timing); returns (ms, plain_ms, bound_ms, bound_by,
    library_ms) for all launches of one decode step."""
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
        time_group(name, [(x, w) for w in ws], ops.bitmap_spmm,
                   lambda w: unpack_bitmap(w).to(torch.bfloat16),
                   torch.matmul, "torch.matmul dense bf16", plain_reps=2)

    seq = []
    x_d, x_f = xs(cfg.d_model), xs(cfg.d_ff)
    for p in periods:
        seq += [(x_d, attn[n].period(p)) for n in ("wq", "wk", "wv", "wo")]
        seq += [(x_d, mlp["w_gate"].period(p)), (x_d, mlp["w_up"].period(p)),
                (x_f, mlp["w_down"].period(p))]
    seq.append((x_d, eng.lm_weight))
    seq = [(x, w, "bitmap_spmm") for x, w in seq]
    return time_step(f"one {cfg.name} decode step", seq,
                     {"bitmap_spmm": ops.bitmap_spmm},
                     {"bitmap_spmm": torch.matmul})


def time_group(name, calls, kernel, densify, library, library_name,
               plain_reps: int = 1) -> None:
    """Per-call times of one group of same-shape calls, cycling through
    every layer's weight so each call finds its weight out of the 50 MB
    L2, as in a decode step."""
    t_k = graph_ms(lambda: [kernel(x, w, impl="cuda") for x, w in calls],
                   20) / len(calls)
    t_e = time_ms(lambda: [kernel(x, w, impl="cuda") for x, w in calls],
                  10) / len(calls)
    few = calls[:4]
    t_p = time_ms(lambda: [kernel(x, w, impl="torch") for x, w in few],
                  plain_reps) / len(few)
    dense = [densify(w) for _, w in calls]
    t_l = graph_ms(lambda: [library(x, d) for (x, _), d in
                            zip(calls, dense)], 20) / len(calls)
    del dense
    moved = sum(call_bound(x, w)[0] for x, w in calls) / len(calls)
    ops_ = sum(call_bound(x, w)[1] for x, w in calls) / len(calls)
    b_ms, by = bound_ms(moved, ops_)
    x, w = calls[0]
    print(f"  {name} {tuple(x.shape)} x {w.shape} ({len(calls)} weights): "
          f"kernel {t_k:.4f} ms | bound {b_ms:.4f} ms ({by}) = "
          f"{100 * b_ms / t_k:.1f}% | {moved / t_k / 1e6:.0f} GB/s | eager "
          f"(host launch included) {t_e:.4f} ms | plain {t_p:.4f} ms | "
          f"{library_name} {t_l:.4f} ms")


def time_step(label, seq, kernels, libraries):
    """One step's launches (``seq`` of (x, weight, kernel name)) timed
    as a CUDA graph: kernel, bound, plain (eager, once) and the library
    call with dense bf16 weights."""
    from repro_torch.sparse.format import unpack_bitmap_stacked
    moved = sum(call_bound(x, w)[0] for x, w, _ in seq)
    ops_ = sum(call_bound(x, w)[1] for x, w, _ in seq)
    b_ms, by = bound_ms(moved, ops_)
    t_k = graph_ms(lambda: [kernels[n](x, w, impl="cuda")
                            for x, w, n in seq], 20)
    t_e = time_ms(lambda: [kernels[n](x, w, impl="cuda")
                           for x, w, n in seq], 10)
    t_p = time_ms(lambda: [kernels[n](x, w, impl="torch")
                           for x, w, n in seq], 1)
    dense = [unpack_bitmap_stacked(w).to(torch.bfloat16) for _, w, _ in seq]
    t_l = graph_ms(lambda: [libraries[n](x, d) for (x, _, n), d in
                            zip(seq, dense)], 20)
    del dense
    print(f"{label}, {len(seq)} launches at M={seq[0][0].shape[-2]}: "
          f"kernel {t_k:.3f} ms (CUDA graph; eager {t_e:.3f} ms) | bound "
          f"{b_ms:.3f} ms ({by}; {moved / 1e9:.3f} GB) = "
          f"{100 * b_ms / t_k:.1f}% | plain {t_p:.3f} ms | library "
          f"(dense bf16) {t_l:.3f} ms (CUDA graph)")
    return t_k, t_p, b_ms, by, t_l


def executed_bytes(eng) -> int:
    """Weight bytes one decode step reads on the kernels' path: every
    packed leaf whole (the capacity dispatch runs all E experts), and
    the dense head's float32 weight, which the head casts every step."""
    packed = sum(bw.hbm_bytes for _, bw in eng.packed.leaves())
    head = (eng.lm_weight.hbm_bytes if eng.lm_weight is not None
            else eng.cfg.d_model * eng.cfg.vocab_size * 4)
    return packed + head


def granite_engine_phase(cfg, device, gen, chunk: int = 16,
                         trace_len: int = 8):
    """Phase 4 (serving); returns the walk engine and the path records
    of both runs."""
    from repro_torch.serve import ServeEngine, poisson_trace
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, num_slots=4, max_len=256, sparsity=0.5, seed=0,
                      device=device)
    ws = eng.weight_stream_report()
    print(f"engine {cfg.name}: init {eng.init_s:.2f}s, prune + pack "
          f"{eng.pack_s:.2f}s (constructor {time.perf_counter() - t0:.2f}s)"
          f" | weight sparsity {eng.weight_sparsity:.4f} | max memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
          f"head fallback: {eng.head_fallback}")
    print(f"weight bytes per decode step: modeled "
          f"{ws['sparse_bytes_per_step'] / 1e9:.3f} GB (activated experts "
          f"min(E, slots x top_k) = {min(cfg.num_experts, ws['activated_experts'])}"
          f" of {cfg.num_experts}; dense "
          f"{ws['dense_bytes_per_step'] / 1e9:.3f} GB) | executed "
          f"{executed_bytes(eng) / 1e9:.3f} GB (all {cfg.num_experts} "
          f"experts)")
    for e in eng.packed.manifest:
        if e.path.startswith("blocks/b0/") and e.packed:
            print(f"  {e.path}: {e.layout} block {e.block} sparsity "
                  f"{e.sparsity:.4f} {e.sparse_bytes / 1e6:.1f} MB of "
                  f"{e.dense_bytes / 1e6:.1f} MB")
    assert_no_dense_copy(eng)
    if cfg.name == "granite-moe-3b-a800m":
        assert per_step(eng) == {"bitmap_spmm": 160,
                                 "bitmap_spmm_grouped": 96}, per_step(eng)
    trace = poisson_trace(trace_len, rate=0.5, seed=0,
                          vocab_size=cfg.vocab_size, prompt_len=(8, 32),
                          max_new=(8, 24))
    rep = serve(eng, trace, "packed engine, prompt walk")
    paths = [check_counts(eng, rep, f"{cfg.name}, prompt walk")]
    decode_step_check(eng, gen)

    t0 = time.perf_counter()
    chunked = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                          prefill_chunk=chunk, device=device)
    print(f"chunked engine (prefill_chunk={chunk}) on the pruned weights: "
          f"pack {chunked.pack_s:.2f}s (constructor "
          f"{time.perf_counter() - t0:.2f}s)")
    assert_no_dense_copy(chunked)
    crep = serve(chunked, trace, f"packed engine, prefill_chunk={chunk}")
    assert crep["prefill"]["calls"] > 0
    paths.append(check_counts(chunked, crep,
                              f"{cfg.name}, prefill_chunk={chunk}"))
    prefill_call_check(chunked, gen, chunk)
    print(f"TTFT p50 {rep['first_token_s']['p50'] * 1e3:.1f} ms walk vs "
          f"{crep['first_token_s']['p50'] * 1e3:.1f} ms chunked | tok/s "
          f"{rep['tok_per_s']:.1f} vs {crep['tok_per_s']:.1f} | decode "
          f"steps {eng.decode_steps} vs {chunked.decode_steps} + "
          f"{crep['prefill']['calls']} prefill calls")
    del chunked
    torch.cuda.empty_cache()

    dense = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                        stream_weights=False, bitmap_head=False,
                        device=device)
    drep = serve(dense, trace, "dense-dispatch engine (yardstick)")
    assert sum(drep["launches"].values()) == 0
    print(f"tok/s packed {rep['tok_per_s']:.1f} vs dense-dispatch "
          f"{drep['tok_per_s']:.1f}")
    del dense
    torch.cuda.empty_cache()
    profile_steps(eng)
    return eng, paths


def granite_timing_phase(eng, device, gen, m: int = 4):
    """Phase 4 (timing): per-call times by group, then K1's 160 and
    K1g's 96 launches of one decode step, then all 256 together.
    Returns {kernel name: (ms, plain_ms, bound_ms, bound_by,
    library_ms)} and the whole step's tuple."""
    from repro_torch.kernels import ops
    from repro_torch.sparse.format import unpack_bitmap_stacked
    cfg = eng.cfg
    e = cfg.num_experts
    attn, moe = eng.packed.blocks["b0"]["attn"], eng.packed.blocks["b0"]["moe"]
    periods = range(cfg.num_periods)

    def xs(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.bfloat16)

    x_d = xs(m, cfg.d_model)
    xg_d, xg_f = xs(e, m, cfg.d_model), xs(e, m, cfg.d_ff)
    k1 = {"q_o": [(x_d, attn[n].period(p)) for p in periods
                  for n in ("wq", "wo")],
          "k_v": [(x_d, attn[n].period(p)) for p in periods
                  for n in ("wk", "wv")],
          "router": [(x_d, moe["router"].period(p)) for p in periods
                     if moe["router"] is not None]}
    k1g = {"gate_up": [(xg_d, moe[n].period(p)) for p in periods
                       for n in ("w_gate", "w_up")],
           "down": [(xg_f, moe["w_down"].period(p)) for p in periods]}
    for name, calls in k1.items():
        if not calls:
            continue            # served dense (no bitmap tile fits)
        time_group(name, calls, ops.bitmap_spmm,
                   lambda w: unpack_bitmap_stacked(w).to(torch.bfloat16),
                   torch.matmul, "torch.matmul dense bf16")
    for name, calls in k1g.items():
        time_group(name, calls, ops.bitmap_spmm_grouped,
                   lambda w: unpack_bitmap_stacked(w).to(torch.bfloat16),
                   torch.bmm, "torch.bmm dense bf16")
    kernels = {"bitmap_spmm": ops.bitmap_spmm,
               "bitmap_spmm_grouped": ops.bitmap_spmm_grouped}
    libraries = {"bitmap_spmm": torch.matmul,
                 "bitmap_spmm_grouped": torch.bmm}
    seq = []
    for p in periods:
        seq += [(x_d, attn[n].period(p), "bitmap_spmm")
                for n in ("wq", "wk", "wv", "wo")]
        if moe["router"] is not None:
            seq.append((x_d, moe["router"].period(p), "bitmap_spmm"))
        seq += [(xg_d, moe["w_gate"].period(p), "bitmap_spmm_grouped"),
                (xg_d, moe["w_up"].period(p), "bitmap_spmm_grouped"),
                (xg_f, moe["w_down"].period(p), "bitmap_spmm_grouped")]
    out = {}
    for name in kernels:
        out[name] = time_step(f"{cfg.name} decode step, {name} only",
                              [s for s in seq if s[2] == name], kernels,
                              libraries)
    whole = time_step(f"one {cfg.name} decode step", seq, kernels,
                      libraries)
    return out, whole


def yardsticks(device, copies: int = 8) -> dict:
    """Phase 5: one library call at the shape each unported kernel would
    take on olmo-1b, with its bound (bytes each input read once and the
    output written once; bf16 operations), called nowhere in the port.
    Each replay cycles through ``copies`` input sets (over 50 MB in all)
    so that no call finds its inputs in the L2."""
    f = torch.nn.functional

    def bf16(*shape):
        return torch.randn(*shape, device=device, dtype=torch.bfloat16)

    qkv = [[bf16(1, 16, 2048, 128) for _ in range(3)] for _ in range(copies)]
    t_att = graph_ms(lambda: [f.scaled_dot_product_attention(
        q, k, v, is_causal=True) for q, k, v in qkv], 20) / copies
    s = 2048
    att_bytes = 4 * qkv[0][0].numel() * 2
    att_ops = 4 * 16 * 128 * s * (s + 1) // 2      # QK^T and PV, causal
    x = bf16(4, 2048)
    ws = [bf16(2048, 8192) for _ in range(copies)]
    t_mm = graph_ms(lambda: [torch.matmul(x, w) for w in ws], 20) / copies
    mm_bytes = (x.numel() + ws[0].numel() + 4 * 8192) * 2
    mm_ops = 2 * 4 * 2048 * 8192
    out = {}
    for name, t, moved, ops_, what in (
            ("K2 flash_attention", t_att, att_bytes, att_ops,
             "scaled_dot_product_attention B1 H16 S2048 D128 causal bf16"),
            ("K3 block_sparse_matmul / K4 nm_spmm", t_mm, mm_bytes, mm_ops,
             "torch.matmul M4 K2048 N8192 bf16 (dense weight)")):
        b, by = bound_ms(moved, ops_)
        out[name] = {"library": what, "library_ms": t, "bound_ms": b,
                     "bound_by": by}
        print(f"  {name}: {what}: {t:.4f} ms | dense bound {b:.4f} ms "
              f"({by}) = {100 * b / t:.1f}%")
    del qkv, ws
    return out


def phase(label: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[{label}: {now - t0:.1f}s]")
    return now


def run(olmo_cfg, granite_cfg, device, gen, olmo_shapes=OLMO_SHAPES,
        granite_shapes=GRANITE_SHAPES,
        expert_shapes=GRANITE_EXPERT_SHAPES) -> dict:
    """Phases 2-5; returns the kernels record.  A kernel's ``launches``
    sums its ``paths`` (each path's run with the counts set to 0 just
    before it); ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are
    one decode step's calls at M = 4 (``ms_scope``)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    t = time.perf_counter()
    worst = {"bitmap_spmm": max(
        kernel_against_plain(device, gen, olmo_shapes, ROWS, SPARSITIES),
        kernel_against_plain(device, gen, granite_shapes, GRANITE_ROWS,
                             GRANITE_SPARSITIES))}
    worst["bitmap_spmm_grouped"] = kernel_against_plain(
        device, gen, expert_shapes, GRANITE_ROWS, GRANITE_SPARSITIES,
        groups=granite_cfg.num_experts)
    print(f"kernels against plain: {dict(LAUNCHES)} comparison launches, "
          f"max |kernel - plain| {worst}")
    reset_launches()
    t = phase("phase 2, kernels against plain", t)

    eng, olmo_path = olmo_engine_phase(olmo_cfg, device, gen)
    olmo_times = olmo_timing_phase(eng, device, gen)
    del eng
    torch.cuda.empty_cache()
    t = phase(f"phase 3, {olmo_cfg.name}", t)

    eng, granite_paths = granite_engine_phase(granite_cfg, device, gen)
    g_times, whole = granite_timing_phase(eng, device, gen)
    del eng
    torch.cuda.empty_cache()
    t = phase(f"phase 4, {granite_cfg.name}", t)

    yard = yardsticks(device)
    print(json.dumps({"library_yardsticks": yard}))
    phase("phase 5, library yardsticks", t)

    def record(name, paths, times, scope, **extra):
        ms, plain_ms, b_ms, by, lib_ms = times
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": sum(p["launches"] for p in paths),
                "paths": paths, "max_abs_err": worst[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": lib_ms, "ms_scope": scope, **extra}

    k1_paths = [olmo_path["bitmap_spmm"]] + [
        p["bitmap_spmm"] for p in granite_paths]
    k1g_paths = [p["bitmap_spmm_grouped"] for p in granite_paths]
    g1 = g_times["bitmap_spmm"]
    return {"kernels": [
        record("bitmap_spmm", k1_paths, olmo_times,
               f"one {olmo_cfg.name} decode step: "
               f"{k1_paths[0]['launches_per_step']} launches at M=4",
               granite={"ms": g1[0], "plain_ms": g1[1], "bound_ms": g1[2],
                        "bound_by": g1[3], "library_ms": g1[4],
                        "ms_scope": f"one {granite_cfg.name} decode step: "
                                    f"{k1_paths[1]['launches_per_step']} "
                                    f"launches at M=4"}),
        record("bitmap_spmm_grouped", k1g_paths,
               g_times["bitmap_spmm_grouped"],
               f"one {granite_cfg.name} decode step: "
               f"{k1g_paths[0]['launches_per_step']} launches at G="
               f"{granite_cfg.num_experts}, M=4 per expert",
               whole_step={"ms": whole[0], "plain_ms": whole[1],
                           "bound_ms": whole[2], "bound_by": whole[3],
                           "library_ms": whole[4],
                           "ms_scope": "both kernels' launches of one "
                                       "decode step"})]}


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
    record = run(get_config("olmo-1b"), get_config("granite-moe-3b-a800m"),
                 torch.device("cuda"), gen)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s"
          f" on {smi} (the kernels line: launches over the main-path runs; "
          f"times per decode step)")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Card and build: prints the card's name and power limit, then builds
   every CUDA source in ``src/repro_torch/kernels/csrc`` for ``sm_90a``
   (one ``nvcc`` per source, all at once, linked into one library with
   five entry points: ``bitmap_spmm``, ``bitmap_spmm_grouped``,
   ``flash_attention``, ``block_sparse`` and ``nm_spmm``; registers,
   shared memory and spills from ptxas).  For each variant of K1 / K1g,
   K2 (path x head dim x type) and K3 / K4 it prints its registers,
   spilled bytes and the counts of tensor-core (``HMMA``), ``ldmatrix``
   (``LDSM``), ``cp.async`` and barrier instructions in its SASS
   (``cuobjdump -sass`` on the built library), and fails if a bf16 K2
   tensor-path variant or a bf16 wide-M K3 / K4 variant has no ``HMMA``.
2. Kernels against their plain versions: ``bitmap_spmm`` (K1) at every
   olmo-1b decode shape (rows M in {1, 4, 8, 130}, weights pruned to
   {0, 0.5, 0.75, 0.95}) and at granite-moe-3b-a800m's attention and
   router shapes (the router's 40-wide output: BN = 40), and
   ``bitmap_spmm_grouped`` (K1g) at granite's 40-expert stacks, rows M
   in {1, 4, 64, 130}, weights pruned to {0, 0.5, 0.95}, and at the
   same shapes a near-empty stack (sparsity 0.99), a stack with all-zero
   tiles and a budget with budget % 4 != 0, each launched twice with
   bit-identical outputs; float32 and bfloat16 X; atol 2e-3·√K (float32)
   / 2e-2·√K (bfloat16), rtol 1e-2.
3. olmo-1b: ``ServeEngine`` on the full configuration (16 layers, full
   widths, seeded random weights) at sparsity 0.5, 4 slots, serving a
   seeded Poisson trace of 8 requests: every request served its whole
   budget, K1 launched 113 times per decode step (7 projections × 16
   layers + the head), no dense copy of a packed weight on the card, and
   one decode step's logits through the kernel agreeing with the plain
   version; the dense-dispatch engine serves the same trace as a
   yardstick.  On the same weights two paged runs (``serve/paging.py``,
   pages of 16 tokens): (a) the prompt walk over the default pool,
   whose tokens must equal the contiguous engine's, 113 K1 launches per
   step, and one paged decode step's logits through the kernels agreeing
   with the plain version; (b) shared-prefix reuse and recompute-on-
   preempt with chunked prefill (16) on a 160-token pool that 8
   requests (a common 32-token prefix, 1-8 own tokens, budgets 16-48)
   overrun: at least one prefix hit and one preemption, the allocator's
   audit clean after the drain, and tokens equal to a contiguous chunked
   engine's, or parting only at a step where that run's top-2 logit
   margin is within 2e-2·√d_model (printed with the request and the
   step).  Then K1 is timed at the four decode shapes (M = 4) and over
   one decode step's 113 launches.
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
   chunked run again on paged KV (pages of 16 tokens) must serve the
   contiguous chunked run's tokens with the same launch counts.  The
   dense-dispatch engine serves the same trace.  Then K1g is timed over
   all 32 layers' expert stacks at M = 4, K1 over granite's 160
   projections, a whole decode step's 256 launches, and the card's idle
   share under ``torch.profiler``.
5. Kernels K2-K4 against their plain versions and timed, through the
   kernel layer's entry points (``ops.flash_attention``,
   ``ops.block_sparse_matmul``, ``kernels.nm_spmm.nm_spmm``) at
   full-width shapes, the counts set to 0 just before the calls and
   read just after: ``flash_attention`` (K2) at olmo-1b's heads (B 2,
   16 heads, S 2048 and a ragged 2047, D 128, causal; bf16 and float32)
   and gemma3-4b's (B 1, 8 query / 4 KV heads, S 4096, D 256, window
   1024 and none; bf16 and float32); ``block_sparse_matmul`` (K3) on
   olmo-1b's gate/up and down shapes with seeded block masks (p_zero
   0.5, 0.75; blocks 128 and 64) and on layer 0's ``w_down`` after
   ``global_l1_prune(0.5)``; ``nm_spmm`` (K4) on layer 0's ``w_gate`` /
   ``w_down`` pruned 1:4 and 2:4; rows M in {4, 130, 2048}, float32 and
   bf16.  Each output must lie within atol + 1e-2·|plain| of the plain
   version, atol the smaller of the reference sweep's (K2: 2e-3 float32
   / 5e-2 bf16; K3 / K4: as phase 2) and 1e-3 (float32) / 5e-2 (bf16)
   times the plain output's rms (per query row for K2, whole for K3 /
   K4), and a zero output must fail that limit at most non-zero
   elements.  Then each is
   timed in bf16 (K2 at each shape, on the path ``flash_attention.plan``
   picks and on its FMA body; K3 / K4 at M = 4 and 2048) beside its
   bound, its plain version and the library call
   (``scaled_dot_product_attention``, ``torch.matmul`` on the dense
   bf16 weight), none of which the port calls; K3 / K4 with their
   TFLOP/s and path (``kernels/tile_product.plan``), K3 at M = 4 also
   on the FMA path.

6. olmo-1b under faults, with the auditor and telemetry, on phase 3's
   weights and knobs (paged, pages of 16, prefix reuse, preemption,
   chunked prefill 16, the 160-token pool): first K1 on a bitmap with
   one extra set bit whose slot lies past a full value budget, against
   the plain version's clamp (dense and sparse-walk tiles, no CUDA
   error).  Then the first 4 requests of phase 3's shared-prefix trace,
   budgets capped at 16 (``audit=True`` copies every packed tensor to
   the host for its CRC32 once per step, ~2.6 GB here, so the trace is
   cut by its steps, not by its width), under ``FaultPlan.chaos(2, 24)``
   with every telemetry artifact: at least 4 faults fired, the NaN head
   and the bit-flipped leaf quarantined, every request DONE with no
   error, no page leaked, tokens equal to phase 3's reuse + preempt run
   or parting only at that contiguous run's near tie, K1 launches per
   decode step and prefill call equal to the packed leaves' count before
   and after each quarantine, the trace / event log / metrics snapshot
   / traffic artifact valid.  It prints the scan's ms per step and by
   part, the step wall against phase 3's, the ledger's bytes per step
   against K1's executed bytes, the paper's 28 nm energy model and the
   H100 roofline against the profiled device time; then the same trace
   with telemetry on and off in turns, and a lifecycle pass (``max_queue``
   refusing one submit, cancels queued and mid-decode, a deadline
   expiring mid-flight with partial tokens; the terminal states
   partition the history and the pool is whole).

Bounds are the larger of the bytes a call must move over 3.35 TB/s and
its operations over 989 TFLOP/s (bf16), with this run's non-zeros, live
score pairs (K2), surviving blocks (K3) or kept values (K4).  The
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
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM, NVIDIA data sheet: HBM3 bytes/s and the dense bf16 peak
from repro_torch.launch.roofline import (BF16_FLOPS_PER_S,  # noqa: E402
                                         HBM_BYTES_PER_S)

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
ATTN_ATOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
# Phase 5 also scales each limit to what it compares: atol this share of
# the rms of the plain output (per (batch, head, query) row for K2, over
# the whole output for K3 / K4), so that a zero output fails.
SCALED_ATOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
RTOL = 1e-2
MATMUL_ROWS = (4, 130, 2048)
BLOCK_P_ZERO = (0.5, 0.75)
BLOCKS = ((128, 128), (64, 64))
NM_PATTERNS = ((1, 4), (2, 4))
L2_BYTES = 50e6
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"bitmap_spmm": CSRC + "bitmap_spmm.cu",
           "bitmap_spmm_grouped": CSRC + "bitmap_spmm.cu",
           "flash_attention": CSRC + "flash_attention.cu",
           "block_sparse_matmul": CSRC + "block_sparse.cu",
           "nm_spmm": CSRC + "nm_spmm.cu"}
REPLACES = {"bitmap_spmm": "src/repro/kernels/bitmap_spmm.py:74",
            "bitmap_spmm_grouped": "src/repro/kernels/bitmap_spmm.py:167",
            "flash_attention": "src/repro/kernels/flash_attention.py:69",
            "block_sparse_matmul": "src/repro/kernels/block_sparse.py:49",
            "nm_spmm": "src/repro/kernels/nm_spmm.py:52"}


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
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_and_build() -> str:
    from repro_torch.kernels import (_build, bitmap_spmm, block_sparse,
                                     flash_attention, nm_spmm)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) | "
          f"device {torch.cuda.get_device_name(0)} | count "
          f"{torch.cuda.device_count()}")
    built = _build.build()
    print(f"build: {built.path.relative_to(ROOT)} from "
          f"{[src.name for src in _build.sources()]} in {built.seconds:.1f}s "
          f"(one nvcc per source, together, then one link)"
          if built.seconds else f"build: {built.path.name} already built")
    for line in built.log.splitlines():
        if "Compiling entry" in line:
            print(f"  {line.split(chr(39))[1][:90]}")
        elif "Used" in line or "spill" in line:
            print(f"    {line.strip()}")
    kernel_variants(built)
    entries = [bitmap_spmm._entry(), bitmap_spmm._entry(grouped=True),
               flash_attention._entry(), block_sparse._entry(),
               nm_spmm._entry()]
    print(f"entry points: {', '.join(fn.__name__ for fn in entries)}")
    return smi


def _toolkit_tool(name: str) -> str:
    from repro_torch.kernels import _build
    return str(pathlib.Path(_build._nvcc()).parent / name)


def ptxas_report(log: str) -> dict:
    """{mangled kernel: (registers, spill store + load bytes)} from the
    build's ``-Xptxas -v`` output."""
    regs, spills, entry, props = {}, {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.split("for ")[-1].strip()
        elif "spill stores" in line and props:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills[props] = nums[1] + nums[2]
        elif "Used" in line and "registers" in line and entry:
            regs[entry] = int(line.split("Used")[1].split()[0])
    return {name: (r, spills.get(name, 0)) for name, r in regs.items()}


SASS_OPS = ("HMMA", "LDSM", "LDGSTS", "BAR")


def sass_counts(lib: pathlib.Path) -> dict:
    """{mangled kernel: {op: count}} of the ``SASS_OPS`` in its SASS
    (tensor-core products, shared-memory matrix loads, cp.async copies,
    barriers), from ``cuobjdump -sass`` on the built library."""
    sass = subprocess.run([_toolkit_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in SASS_OPS:
                if f" {op}" in line:
                    counts[name][op] += 1
    return counts


def demangle(names) -> dict:
    names = list(names)
    try:
        out = subprocess.run([_toolkit_tool("cu++filt")], input="\n".join(
            names), capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = names
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


# Phase 1's variant groups: (label, which kernels, the variants that must
# run HMMA, how many of those there must be).
VARIANT_GROUPS = (
    ("K1 / K1g", "bitmap_spmm_kernel", None, 0),
    ("K2", "flash_attention", "flash_attention_mma", 4),
    ("K3 / K4", ("block_sparse", "nm_spmm"), "mma_wide", 8),
)


def check_variants(report: dict, sass: dict, plain: dict) -> dict:
    """Phase 1's table: for each group of ``VARIANT_GROUPS`` its variants'
    registers, spilled bytes and SASS counts, printed; fails unless every
    variant of the group that must run on the tensor cores (K2's bf16
    tensor path at each head dim; K3's and K4's bf16 wide-M variants) has
    HMMA instructions, and there are as many of them as expected.
    Returns {group label: (variants, spilling, tensor variants)}."""
    out = {}
    for label, match, tensor, expect in VARIANT_GROUPS:
        keys = (match,) if isinstance(match, str) else match
        ours = sorted(n for n in sass if any(key in n for key in keys))
        print(f"{label} variants ({len(ours)}): registers, spilled bytes, "
              f"{' / '.join(SASS_OPS)} instructions in the SASS (cuobjdump "
              f"-sass)")
        mma = 0
        for name in ours:
            regs, spill = report.get(name, (None, None))
            text = plain.get(name, name).replace("(anonymous namespace)::", "")
            text = text.split("(")[0].replace("__nv_bfloat16", "bf16")
            ops = " / ".join(str(sass[name][op]) for op in SASS_OPS)
            print(f"  {text}: {regs} registers, {spill} bytes spilled, {ops}")
            if tensor and tensor in name:
                assert sass[name]["HMMA"] > 0, f"{text}: no HMMA instruction"
                mma += 1
        assert mma == expect, (label, mma, expect)
        spilled = sum(1 for n in ours if report.get(n, (0, 0))[1])
        print(f"{label}: {len(ours)} variants, {spilled} spilling"
              + (f"; every tensor-core variant ({mma}) runs HMMA"
                 if expect else ""))
        out[label] = (len(ours), spilled, mma)
    return out


def kernel_variants(built) -> None:
    """Phase 1 for every kernel: each variant's registers, spills and
    SASS instruction counts (``check_variants``)."""
    sass = sass_counts(built.path)
    check_variants(ptxas_report(built.log), sass, demangle(sass))


def _compare(name, out, ref, k, dt) -> float:
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(),
                          atol=ATOL[dt] * math.sqrt(k), rtol=1e-2):
        raise AssertionError(f"{name} {dt}: max |kernel - plain| {err}")
    return err


def scaled_compare(name, out, ref, fixed, rms) -> tuple:
    """Phase 5's check of one output against its plain version:
    |kernel - plain| <= atol + ``RTOL``·|plain| at every element, atol
    the smaller of ``fixed`` (the reference sweep's limit) and
    ``SCALED_ATOL`` x ``rms`` (the plain output's rms, broadcast).  The
    limit is itself checked: a zero output must fail it at most of the
    elements where the plain output is not zero.  Raises on either
    failure.  Returns (max |kernel - plain|, the largest share of the
    limit used, the share of those elements at which a zero output
    fails)."""
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    scaled = SCALED_ATOL[ref.dtype]
    out, ref = out.float(), ref.float()
    atol = torch.clamp(scaled * rms, max=fixed)
    limit = atol + RTOL * ref.abs()
    diff = (out - ref).abs()
    # 0 / 0 (a zero limit met exactly) is within it
    used = torch.nan_to_num(diff / limit, nan=0.0, posinf=math.inf
                            ).max().item()
    live = ref != 0      # where no limit can tell a zero output apart
    zero_fails = ((ref.abs() > limit)[live].float().mean().item()
                  if live.any() else math.nan)
    err = diff.max().item()
    if not used <= 1.0:
        raise AssertionError(f"{name}: kernel differs from plain, {used} of "
                             f"the limit, max |diff| {err}")
    if live.any() and not zero_fails > 0.5:
        raise AssertionError(f"{name}: the limit passes a zero output at "
                             f"{100 * (1 - zero_fails):.1f}% of the non-zero "
                             f"elements")
    return err, used, zero_fails


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


def with_budget(bw, budget: int):
    """``bw`` packed with a larger ``budget``: its value slots padded with
    zeros (the same weight; with budget % 4 != 0 most tiles' values start
    off a 16-byte boundary)."""
    values = torch.nn.functional.pad(bw.values, (0, budget - bw.budget))
    return dataclasses.replace(bw, values=values.contiguous())


def grouped_edge_cases(device, gen, expert_shapes, rows, groups) -> float:
    """Phase 2's K1g cases beyond the sweep, at granite's expert shapes:
    a near-empty stack (sparsity 0.99, what global pruning at 0.5 leaves
    of granite's ``w_down``), a stack with all-zero tiles, and a budget
    with budget % 4 != 0.  Each against its plain version, float32 and
    bf16 X, and launched twice: the two outputs must be bit-identical.
    Returns the largest absolute difference seen."""
    from repro_torch.kernels import ops
    from repro_torch.serve.packed import choose_block
    from repro_torch.sparse import pack_bitmap_experts, per_tensor_prune
    worst = 0.0
    for name, k, n in expert_shapes:
        block = choose_block(k, n)
        base = torch.randn(groups, k, n, generator=gen, device=device)
        near_empty = per_tensor_prune(base, 0.99)
        holes = per_tensor_prune(base, 0.5)
        holes[::3, : block[0], :] = 0.0        # every third expert: a zero
        holes[1::4, :, : block[1]] = 0.0       # K row or N column of tiles
        packed = {"sparsity 0.99": pack_bitmap_experts(near_empty[None],
                                                       block=block),
                  "all-zero tiles": pack_bitmap_experts(holes[None],
                                                        block=block)}
        bw = packed["all-zero tiles"]
        packed["budget % 4 = 3"] = with_budget(bw, bw.budget | 3)
        for label, bw in packed.items():
            bw = bw.period(0)
            err = 0.0
            for m in rows:
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn(groups, m, k, generator=gen,
                                    device=device).to(dt)
                    out = ops.bitmap_spmm_grouped(x, bw, impl="cuda")
                    again = ops.bitmap_spmm_grouped(x, bw, impl="cuda")
                    ref = ops.bitmap_spmm_grouped(x, bw, impl="torch")
                    sync()
                    assert torch.equal(out, again), (name, label, m, dt)
                    err = max(err, _compare(f"{name} {label} M={m}", out,
                                            ref, k, dt))
            worst = max(worst, err)
            print(f"  {name} G={groups} K={k} N={n} {label}: budget "
                  f"{bw.budget}, max |kernel - plain| {err:.3g} over "
                  f"M={list(rows)}, f32 and bf16; two launches bit-identical")
    return worst


def assert_no_dense_copy(eng) -> None:
    assert eng.lm_weight is None or eng.lm_weight.dense_cache is None
    assert all(bw.dense_cache is None for _, bw in eng.packed.leaves())
    assert all(bw.values.is_cuda for _, bw in eng.packed.leaves())


def per_step(eng, prefill: bool = False) -> dict:
    """Kernel launches one decode step (or, ``prefill``, one prefill
    call) makes: one per packed leaf per period, plus the head when it is
    packed (decode steps only: a prefill call has no head)."""
    cfg = eng.cfg
    layouts = [e.layout for e in eng.packed.packed_entries]
    head = eng.lm_weight is not None and not prefill
    return {"bitmap_spmm": cfg.num_periods * layouts.count("stacked")
            + head,
            "bitmap_spmm_grouped": cfg.num_periods * layouts.count("grouped")}


def serve(eng, trace, label: str) -> dict:
    """Serve ``trace`` on a warm engine with the launch counts set to 0
    just before and read just after; returns its report with the
    counts, the served tokens and the prompt lengths."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import RequestState
    eng.warmup()
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reqs = [eng.submit(**spec) for spec in trace]
    rep = eng.run()
    rep["launches"] = dict(LAUNCHES)
    rep["tokens"] = [list(r.tokens) for r in reqs]
    rep["prompt_lens"] = [len(r.prompt) for r in reqs]
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
    expect, per_call = per_step(eng), per_step(eng, prefill=True)
    calls = rep["prefill"]["calls"]
    for name, n in expect.items():
        want = n * eng.decode_steps + per_call[name] * calls
        assert rep["launches"][name] == want, (name, rep["launches"],
                                               expect, per_call, calls)
        if n:
            assert rep["launches"][name] > 0, (name, label)
    print(f"main path {label}: {rep['launches']} = {expect} per decode "
          f"step x {eng.decode_steps} + {per_call} per prefill call x "
          f"{calls}")
    return {name: {"path": label, "launches": rep["launches"][name],
                   "launches_per_step": n,
                   "launches_per_prefill_call": per_call[name],
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
    the plain versions, on copies of the engine's cache.  A paged engine
    steps through page tables that give each slot its own pages."""
    from repro_torch.models.model import decode_step
    cfg, device = eng.cfg, eng.device
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                        device=device)
    pos = torch.tensor([3, 17, 64, 200], device=device)
    tables = None
    if eng.page_len:
        tables = {b: torch.arange(1, 4 * p.page_slots + 1,
                                  device=device).reshape(4, p.page_slots)
                  for b, p in eng.kv.pools.items()}
    out = {}
    for impl in (None, "torch"):
        cache = {b: {k: t.clone() for k, t in leaf.items()}
                 for b, leaf in eng.kv.cache.items()}
        out[impl], _ = decode_step(eng.params, cache, cfg, tok, pos,
                                   lm_weight=eng.lm_weight,
                                   packed=eng.packed.blocks, lm_impl=impl,
                                   page_tables=tables)
        del cache
    sync()
    assert out[None].shape == (4, cfg.vocab_size)
    agree(out[None], out["torch"],
          "paged decode-step logits" if tables else "decode-step logits")


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


def profile_steps(eng, steps: int = 6):
    """Device busy share of full-batch decode steps (torch.profiler):
    kernel time summed per name over the steps' wall time.  Returns the
    device's busy ms per step, or None when the profiler saw no device
    time."""
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
        return None
    spmm_us = sum(t for k, t in kernels
                  if "bitmap_spmm" in k)
    top = sorted(kernels, key=lambda kt: -kt[1])[:4]
    print(f"profiler {eng.cfg.name}, {steps} decode steps: "
          f"{wall_us / steps / 1e3:.2f} ms per step, device busy "
          f"{busy_us / steps / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%;"
          f" idle {100 * (1 - busy_us / wall_us):.1f}%), bitmap_spmm "
          f"kernels {spmm_us / steps / 1e3:.2f} ms per step | top: "
          + ", ".join(f"{k[:40]} {t / steps / 1e3:.2f} ms" for k, t in top))
    return busy_us / steps / 1e3


def record_margins(eng) -> dict:
    """Keep each slot's top-2 logit margin by (rid, position) at every
    decode step of ``eng``."""
    margins = {}
    decode = eng._decode

    def recording():
        nxt, logits, cache = decode()
        top2 = logits.float().topk(2, dim=-1).values
        m = (top2[:, 0] - top2[:, 1]).tolist()
        for slot, req in eng.scheduler.active.items():
            margins[(req.rid, int(eng._pos[slot]))] = m[slot]
        return nxt, logits, cache

    eng._decode = recording
    return margins


def same_tokens_or_near_tie(got: dict, want: dict, margins: dict, d: int,
                            label: str) -> int:
    """``got``'s tokens equal ``want``'s, or a request parts only at a
    step where ``want``'s run had a top-2 margin within 2e-2·√d (a near
    tie that bf16 rounding may break either way).  Prints each parting;
    returns how many requests parted."""
    tol = 2e-2 * math.sqrt(d)
    parted = 0
    for rid, (a, b) in enumerate(zip(want["tokens"], got["tokens"])):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        pos = want["prompt_lens"][rid] - 1 + i
        margin = margins[(rid, pos)]
        print(f"{label}: request {rid} parts at token {i} (position "
              f"{pos}) with top-2 margin {margin:.4g} (limit {tol:.4g})")
        assert margin <= tol, (label, rid, i, margin, tol)
        parted += 1
    print(f"{label}: {len(want['tokens']) - parted} of "
          f"{len(want['tokens'])} requests served identical tokens")
    return parted


def shared_prefix_trace(vocab: int, n: int = 8, prefix: int = 32,
                        seed: int = 0) -> list:
    """``n`` requests, one every 4 steps: a common ``prefix``-token
    prompt prefix, then 1-8 tokens of their own; budgets spread evenly
    over 16-48, in a seeded order."""
    g = torch.Generator().manual_seed(seed)
    common = torch.randint(0, vocab, (prefix,), generator=g).tolist()
    budgets = torch.linspace(16, 48, n).round().long()[
        torch.randperm(n, generator=g)].tolist()
    trace = []
    for i, budget in enumerate(budgets):
        own = int(torch.randint(1, 9, (1,), generator=g))
        trace.append({
            "prompt": common + torch.randint(0, vocab, (own,),
                                             generator=g).tolist(),
            "max_new_tokens": budget, "arrival": 4.0 * i})
    return trace


def paged_olmo_runs(eng, trace, rep, device, gen):
    """Phase 3's paged runs on ``eng``'s pruned weights: (a) the prompt
    walk, (b) prefix reuse and preemption against a contiguous chunked
    run.  Returns their path records, and what phase 6 reuses: the
    shared-prefix trace, the reuse + preempt run's report and the
    contiguous run's top-2 margins."""
    from repro_torch.serve import ServeEngine
    cfg = eng.cfg
    same = dict(num_slots=4, max_len=256, params=eng.params,
                head_sparsity=eng.head_sparsity, device=device)
    t0 = time.perf_counter()
    paged = ServeEngine(cfg, paged=True, page_len=16, **same)
    assert_no_dense_copy(paged)
    prep = serve(paged, trace, "paged engine (page_len 16), prompt walk")
    path = check_counts(paged, prep, f"{cfg.name}, paged, prompt walk")
    assert prep["tokens"] == rep["tokens"], "paged walk parts"
    assert prep["paging"]["pages_in_use"] == 0
    paged.kv.audit()
    decode_step_check(paged, gen)
    pg = prep["paging"]
    print(f"paged walk: tokens equal the contiguous engine's | tok/s "
          f"{prep['tok_per_s']:.1f} paged vs {rep['tok_per_s']:.1f} "
          f"contiguous | wall per decode step "
          f"{1e3 * prep['wall_s'] / paged.decode_steps:.2f} ms vs "
          f"{1e3 * rep['wall_s'] / eng.decode_steps:.2f} ms | pages peak "
          f"{pg['pages_peak']} of {pg['pages_total']} | reserved KV "
          f"{pg['reserved_kv_bytes'] / 2**20:.1f} MiB vs contiguous "
          f"{pg['contiguous_kv_bytes'] / 2**20:.1f} MiB "
          f"[run {time.perf_counter() - t0:.1f}s]")
    paths = [path]
    del paged

    t0 = time.perf_counter()
    rtrace = shared_prefix_trace(cfg.vocab_size)
    contig = ServeEngine(cfg, prefill_chunk=16, **same)
    margins = record_margins(contig)
    crep = serve(contig, rtrace, "contiguous chunked engine (16), shared "
                                 "prefixes")
    del contig
    print(f"[run {time.perf_counter() - t0:.1f}s]")
    t0 = time.perf_counter()
    reuse = ServeEngine(cfg, paged=True, page_len=16, prefill_chunk=16,
                        prefix_reuse=True, preempt=True,
                        page_pool_tokens=160, **same)
    assert_no_dense_copy(reuse)
    rrep = serve(reuse, rtrace, "paged engine, prefix reuse + preempt, "
                                "160-token pool")
    paths.append(check_counts(reuse, rrep,
                              f"{cfg.name}, paged, prefix reuse + preempt"))
    pr, pe = rrep["prefix_reuse"], rrep["prefix_reuse"]["preempt"]
    reuse.kv.audit()
    assert rrep["paging"]["pages_in_use"] == len(reuse.kv.prefix) * len(
        reuse.kv.pools) and \
        pr["hits"] >= 1 and pe["count"] >= 1, (pr, rrep["paging"])
    print(f"prefix reuse + preempt: {pr['hits']} hits / {pr['misses']} "
          f"misses, {pr['hit_tokens']} tokens adopted, {pr['forks']} "
          f"forks, {pr['evictions']} evictions | {pe['count']} preemptions,"
          f" {pe['recomputed_tokens']} tokens recomputed | pages peak "
          f"{rrep['paging']['pages_peak']} of "
          f"{rrep['paging']['pages_total']} | audit clean | tok/s "
          f"{rrep['tok_per_s']:.1f} vs contiguous chunked "
          f"{crep['tok_per_s']:.1f} | TTFT p50 "
          f"{rrep['first_token_s']['p50'] * 1e3:.1f} ms vs "
          f"{crep['first_token_s']['p50'] * 1e3:.1f} ms "
          f"[run {time.perf_counter() - t0:.1f}s]")
    same_tokens_or_near_tie(rrep, crep, margins, cfg.d_model,
                            "reuse + preempt vs contiguous chunked")
    del reuse
    torch.cuda.empty_cache()
    return paths, {"trace": rtrace, "reuse": rrep, "margins": margins}


def olmo_engine_phase(cfg, device, gen, trace_len: int = 8):
    """Phase 3 (serving); returns the packed engine, its path records
    and what phase 6 reuses (``paged_olmo_runs``, with the profiled
    device busy ms per decode step)."""
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
    paths = [check_counts(eng, rep, f"{cfg.name}, prompt walk")]
    decode_step_check(eng, gen)
    paged_paths, shared = paged_olmo_runs(eng, trace, rep, device, gen)
    paths += paged_paths
    shared["busy_ms"] = profile_steps(eng)

    dense = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                        stream_weights=False, bitmap_head=False,
                        device=device)
    drep = serve(dense, trace, "dense-dispatch engine (yardstick)")
    assert sum(drep["launches"].values()) == 0
    print(f"tok/s packed {rep['tok_per_s']:.1f} vs dense-dispatch "
          f"{drep['tok_per_s']:.1f}")
    del dense
    return eng, paths, shared


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

    t0 = time.perf_counter()
    paged = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                        prefill_chunk=chunk, paged=True, page_len=16,
                        device=device)
    assert_no_dense_copy(paged)
    prep = serve(paged, trace, f"paged engine (page_len 16), "
                               f"prefill_chunk={chunk}")
    paths.append(check_counts(paged, prep, f"{cfg.name}, paged, "
                                           f"prefill_chunk={chunk}"))
    assert prep["tokens"] == crep["tokens"], "paged chunked parts"
    paged.kv.audit()
    print(f"paged chunked: tokens equal the contiguous chunked run's | "
          f"tok/s {prep['tok_per_s']:.1f} vs {crep['tok_per_s']:.1f} | "
          f"TTFT p50 {prep['first_token_s']['p50'] * 1e3:.1f} ms | pages "
          f"peak {prep['paging']['pages_peak']} of "
          f"{prep['paging']['pages_total']} "
          f"[run {time.perf_counter() - t0:.1f}s]")
    del paged
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


def attention_cases(olmo_cfg, gemma_cfg, seq_olmo: int = 2048,
                    seq_gemma: int = 4096):
    """Phase 5's K2 shapes, from the two configs: (label, B, Hq, Hkv, S,
    D, window, dtype)."""
    window = next(b.window for b in gemma_cfg.pattern if b.window)

    def heads(cfg, s):
        return cfg.num_heads, cfg.num_kv_heads, s, cfg.resolved_head_dim

    bf16, f32 = torch.bfloat16, torch.float32
    olmo, gemma = olmo_cfg.name, gemma_cfg.name
    return [(f"{olmo} causal", 2, *heads(olmo_cfg, seq_olmo), None, bf16),
            (f"{olmo} causal", 2, *heads(olmo_cfg, seq_olmo), None, f32),
            (f"{olmo} causal, ragged", 2, *heads(olmo_cfg, seq_olmo - 1),
             None, bf16),
            (f"{gemma} local", 1, *heads(gemma_cfg, seq_gemma), window,
             bf16),
            (f"{gemma} global", 1, *heads(gemma_cfg, seq_gemma), None,
             bf16),
            (f"{gemma} local", 1, *heads(gemma_cfg, seq_gemma), window, f32),
            (f"{gemma} global", 1, *heads(gemma_cfg, seq_gemma), None, f32)]


def matmul_weights(olmo_cfg, device, gen):
    """Phase 5's K3 and K4 weights, float32 (K, N), at olmo-1b's
    full-width MLP shapes: seeded block masks (the construction of
    ``benchmarks/kernel_bench.py``) for K3, layer 0's ``w_down`` after
    ``global_l1_prune(0.5)`` of the whole model for K3, and layer 0's
    ``w_gate``/``w_down`` pruned N:M for K4.  Returns (K3 list, K4 list)
    of (label, weight, block, N:M or None, timed)."""
    from repro_torch.models.model import init_params
    from repro_torch.sparse import global_l1_prune, prune_nm
    d, f = olmo_cfg.d_model, olmo_cfg.d_ff
    k3 = []
    for name, k, n in (("gate_up", d, f), ("down", f, d)):
        for block in BLOCKS:
            kt, nt = k // block[0], n // block[1]
            for p_zero in BLOCK_P_ZERO:
                keep = torch.rand(kt, nt, generator=gen,
                                  device=device) >= p_zero
                w = torch.randn(k, n, generator=gen, device=device)
                w = (w.view(kt, block[0], nt, block[1])
                     * keep[:, None, :, None]).view(k, n)
                timed = (name, block, p_zero) in (
                    ("gate_up", (128, 128), 0.5), ("down", (64, 64), 0.75))
                k3.append((f"{name} {k}x{n} block {block} p_zero {p_zero}",
                           w, block, None, timed))
    params = init_params(gen, olmo_cfg, device=device)
    mlp = params["blocks"]["b0"]["mlp"]
    w_gate, w_down = mlp["w_gate"][0].clone(), mlp["w_down"][0].clone()
    pruned = global_l1_prune(params, 0.5)["blocks"]["b0"]["mlp"][
        "w_down"][0].clone()
    del params, mlp
    torch.cuda.empty_cache()
    k3.append((f"{olmo_cfg.name} w_down[0] {f}x{d} global_l1_prune(0.5) "
               f"block (128, 128)", pruned, (128, 128), None, True))
    k4 = [(f"{olmo_cfg.name} {name}[0] {tuple(w.shape)} {n}:{m} block "
           f"{block}", prune_nm(w, n, m), block, (n, m),
           (name, block) == ("w_gate", (128, 128))
           or (name, block, n) == ("w_down", (64, 64), 2))
          for name, w in (("w_gate", w_gate), ("w_down", w_down))
          for n, m in NM_PATTERNS for block in BLOCKS]
    return k3, k4


def _pack(w, block, nm, dtype):
    from repro_torch.sparse import pack_block_sparse, pack_nm
    w = w.to(dtype)
    return pack_nm(w, *nm, block=block) if nm else pack_block_sparse(
        w, block=block)


def _dense(bw):
    from repro_torch.sparse import unpack_block_sparse, unpack_nm
    return unpack_nm(bw) if hasattr(bw, "idx") else unpack_block_sparse(bw)


def _sdpa_args(q, k, window) -> dict:
    """Keyword arguments that make ``scaled_dot_product_attention`` (the
    library call for K2, never called by the port) compute K2's mask:
    causal, or with the window an explicit boolean mask; GQA when the
    head counts differ."""
    gqa = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
    if window is None:
        return {"is_causal": True, **gqa}
    pos_q = torch.arange(q.shape[2], device=q.device)[:, None]
    pos_k = torch.arange(k.shape[2], device=q.device)[None, :]
    return {"attn_mask": (pos_q >= pos_k) & (pos_q - pos_k < window), **gqa}


def _sdpa_backend(q, k, v, args) -> str:
    """Which SDPA backend PyTorch picks for these inputs."""
    choice = torch._fused_sdp_choice(
        q, k, v, args.get("attn_mask"), 0.0, args.get("is_causal", False),
        **{key: args[key] for key in ("enable_gqa",) if key in args})
    return torch.nn.attention.SDPBackend(choice).name


def _copies(nbytes: int) -> int:
    """Input sets a replay cycles through so that no call finds its
    inputs in the 50 MB L2."""
    return max(2, math.ceil(1.25 * L2_BYTES / nbytes))


def time_attention(label, q, k, v, window):
    """K2 at one shape: kernel and SDPA as CUDA-graph replays cycling
    input sets past the L2, the plain version eagerly (once: it is
    slow); bound from this call's live score pairs."""
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.kernels.flash_attention import live_pairs, plan
    b, hq, sq, d = q.shape
    moved = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    sets = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                          for _ in range(_copies(moved) - 1)]
    t_k = graph_ms(lambda: [ops.flash_attention(*s, window=window)
                            for s in sets], 10) / len(sets)
    # the FMA body on the same inputs, beside the path the plan picks
    t_f = graph_ms(lambda: [flash_attention.flash_attention(
        *s, window=window, path="fma") for s in sets], 10) / len(sets)
    t_p = time_ms(lambda: ops.flash_attention(q, k, v, impl="torch",
                                              window=window), 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    args = _sdpa_args(q, k, window)
    t_l = graph_ms(lambda: [sdpa(*s, **args) for s in sets], 10) / len(sets)
    pairs = b * hq * live_pairs(sq, k.shape[2], True, window)
    b_ms, by = bound_ms(moved, 4 * d * pairs)
    backend = _sdpa_backend(q, k, v, args)
    lib_err = (sdpa(q, k, v, **args).float()
               - ops.flash_attention(q, k, v, window=window).float()
               ).abs().max().item()
    path = plan(q.dtype, d)
    print(f"  K2 {label} {tuple(q.shape)} kv {tuple(k.shape)} window "
          f"{window}: kernel ({path} path) {t_k:.4f} ms | bound {b_ms:.4f} "
          f"ms ({by}; {pairs} live pairs) = {100 * b_ms / t_k:.1f}% | "
          f"{4 * d * pairs / t_k / 1e9:.1f} TFLOP/s | FMA path {t_f:.4f} ms "
          f"({4 * d * pairs / t_f / 1e9:.1f} TFLOP/s) | plain {t_p:.4f} ms | "
          f"SDPA ({backend}) {t_l:.4f} ms, max |SDPA - kernel| "
          f"{lib_err:.3g}")
    del sets
    return {"shape": label, "window": window, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": by, "library_ms": t_l,
            "library": f"scaled_dot_product_attention ({backend})",
            "path": path, "tflops": 4 * d * pairs / t_k / 1e9,
            "fma_path_ms": t_f}


def time_matmul(name, label, x, bw, kernel):
    """K3 or K4 on one weight at one M: kernel and ``torch.matmul`` on
    the dense bf16 weight as CUDA-graph replays cycling input sets past
    the L2, the plain version eagerly; bound from the weight's surviving
    blocks (K3) or kept values (K4) in this run; TFLOP/s over the same
    operations.  K3 at decode M is also timed on the FMA path."""
    from repro_torch.kernels import block_sparse
    from repro_torch.kernels.tile_product import Plan, plan
    m, k = x.shape
    n = bw.shape[1]
    if name == "nm_spmm":
        kept = bw.values.numel()
        w_bytes = bw.hbm_bytes
    else:
        kept = int(bw.nnzb.sum()) * bw.block[0] * bw.block[1]
        w_bytes = (int(bw.nnzb.sum()) * bw.block[0] * bw.block[1]
                   * bw.values.element_size() + 4 * (bw.kidx.numel()
                                                     + bw.nnzb.numel()))
    moved = (m * k + m * n) * x.element_size() + w_bytes
    per_call = (m * k + m * n) * x.element_size() + bw.hbm_bytes
    clone = dataclasses.replace
    sets = [(x, bw)] + [
        (x.clone(), clone(bw, values=bw.values.clone(),
                          **({"idx": bw.idx.clone()} if name == "nm_spmm"
                             else {"kidx": bw.kidx.clone(),
                                   "nnzb": bw.nnzb.clone()})))
        for _ in range(_copies(per_call) - 1)]
    t_k = graph_ms(lambda: [kernel(a, w) for a, w in sets], 20) / len(sets)
    t_p = time_ms(lambda: kernel(x, bw, impl="torch"), 2)
    dense = [(a, _dense(w).to(torch.bfloat16)) for a, w in sets]
    t_l = graph_ms(lambda: [torch.matmul(a, w) for a, w in dense],
                   20) / len(sets)
    b_ms, by = bound_ms(moved, 2 * m * kept)
    p = plan(m, x.dtype, bw.block[0])
    extra, alt = {}, ""
    if name == "block_sparse_matmul" and p.path == "decode":
        # the FMA path on the same call, for the decode path's choice
        t_f = graph_ms(lambda: [block_sparse.block_sparse_matmul(
            a, w, p=Plan("fma", 8)) for a, w in sets], 20) / len(sets)
        extra, alt = {"fma_path_ms": t_f}, f" | FMA path {t_f:.4f} ms"
    tflops = 2 * m * kept / t_k / 1e9
    print(f"  {name} {label} M={m}: kernel ({p.path} path) {t_k:.4f} ms, "
          f"{tflops:.1f} TFLOP/s | bound {b_ms:.4f} ms ({by}) = "
          f"{100 * b_ms / t_k:.1f}% | plain {t_p:.4f} ms | torch.matmul "
          f"dense bf16 {t_l:.4f} ms{alt}")
    del sets, dense
    return {"shape": f"{label}, M={m}", "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": by, "library_ms": t_l,
            "library": "torch.matmul dense bf16", "path": p.path,
            "tflops": tflops, **extra}


def kernel_layer_phase(olmo_cfg, gemma_cfg, device, gen,
                       attn=None, rows=MATMUL_ROWS, timed_rows=(4, 2048)):
    """Phase 5: K2-K4 through the kernel layer's entry points at
    full-width shapes.  The main path (every call through
    ``ops.flash_attention``, ``ops.block_sparse_matmul`` and
    ``nm_spmm``, counts set to 0 just before and read just after), then
    each output against the plain version on the same inputs, then the
    bf16 timings.  Returns {kernel: (path record, max |kernel - plain|,
    timings)}."""
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels.nm_spmm import nm_spmm
    attn = attn if attn is not None else attention_cases(olmo_cfg,
                                                         gemma_cfg)
    attn_in = []
    for label, b, hq, hkv, s, d, window, dt in attn:
        q = torch.randn(b, hq, s, d, generator=gen, device=device).to(dt)
        k, v = (torch.randn(b, hkv, s, d, generator=gen,
                            device=device).to(dt) for _ in range(2))
        attn_in.append((label, q, k, v, window))
    k3_w, k4_w = matmul_weights(olmo_cfg, device, gen)
    dtypes = (torch.float32, torch.bfloat16)
    packed = {dt: {name: [(label, _pack(w, block, nm, dt))
                          for label, w, block, nm, _ in ws]
                   for name, ws in (("block_sparse_matmul", k3_w),
                                    ("nm_spmm", k4_w))} for dt in dtypes}
    timed = {name: [label for label, *_, t in ws if t]
             for name, ws in (("block_sparse_matmul", k3_w),
                              ("nm_spmm", k4_w))}
    xs = {(k, m, dt): torch.randn(m, k, generator=gen, device=device).to(dt)
          for k in {olmo_cfg.d_model, olmo_cfg.d_ff} for m in rows
          for dt in dtypes}
    kernels = {"block_sparse_matmul": ops.block_sparse_matmul,
               "nm_spmm": nm_spmm}
    del k3_w, k4_w
    sync()

    reset_launches()
    a_out = [ops.flash_attention(q, k, v, window=window)
             for _, q, k, v, window in attn_in]
    m_out = {name: [(label, m, dt, kernels[name](xs[bw.shape[0], m, dt], bw))
                    for dt in dtypes for label, bw in packed[dt][name]
                    for m in rows] for name in kernels}
    sync()
    launches = dict(LAUNCHES)
    calls = {"flash_attention": len(a_out),
             **{name: len(out) for name, out in m_out.items()}}
    assert launches == {"bitmap_spmm": 0, "bitmap_spmm_grouped": 0,
                        **calls}, (launches, calls)
    print(f"main path, kernel layer entry points at full width: launches "
          f"{launches}")

    worst = {name: 0.0 for name in calls}
    for (label, q, k, v, window), out in zip(attn_in, a_out):
        ref = ops.flash_attention(q, k, v, impl="torch", window=window)
        sync()
        assert out.shape == q.shape and bool(torch.isfinite(out).all())
        rms = ref.float().square().mean(-1, keepdim=True).sqrt()
        name = (f"K2 {label} {tuple(q.shape)} kv {tuple(k.shape)} window "
                f"{window} {q.dtype}")
        err, used, zero = scaled_compare(name, out, ref, ATTN_ATOL[q.dtype],
                                         rms)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        print(f"  {name}: max |kernel - plain| {err:.3g}, {used:.3g} of the "
              f"limit (atol min({ATTN_ATOL[q.dtype]}, "
              f"{SCALED_ATOL[q.dtype]} x row rms {rms.min().item():.3g}.."
              f"{rms.max().item():.3g}), rtol {RTOL}); a zero output fails "
              f"at {100 * zero:.1f}% of the non-zero elements")
        del ref, rms
    del a_out
    for name, outs in m_out.items():
        by_weight = {}
        for label, m, dt, out in outs:
            bw = dict(packed[dt][name])[label]
            x = xs[bw.shape[0], m, dt]
            ref = kernels[name](x, bw, impl="torch")
            rms = ref.float().square().mean().sqrt()
            res = scaled_compare(f"{name} {label} M={m} {dt}", out, ref,
                                 ATOL[dt] * math.sqrt(bw.shape[0]), rms)
            worst[name] = max(worst[name], res[0])
            by_weight.setdefault(label, []).append((*res, rms.item()))
        for label, res in by_weight.items():
            err, used, zero, rms = zip(*res)
            print(f"  {name} {label}: max |kernel - plain| {max(err):.3g}, "
                  f"{max(used):.3g} of the limit (atol min(phase 2's, "
                  f"{SCALED_ATOL[torch.float32]} / "
                  f"{SCALED_ATOL[torch.bfloat16]} x rms {min(rms):.3g}.."
                  f"{max(rms):.3g}) for float32 / bf16, rtol {RTOL}); a zero "
                  f"output fails at >= {100 * min(zero):.1f}% of the non-zero "
                  f"elements; "
                  f"M={list(rows)}")
    del m_out
    torch.cuda.empty_cache()

    timings = {name: [] for name in calls}
    for label, q, k, v, window in attn_in:
        if q.dtype == torch.bfloat16:
            timings["flash_attention"].append(
                time_attention(label, q, k, v, window))
    del attn_in
    for name, labels in timed.items():
        bf = dict(packed[torch.bfloat16][name])
        for label in labels:
            bw = bf[label]
            for m in timed_rows:
                timings[name].append(time_matmul(
                    name, label, xs[bw.shape[0], m, torch.bfloat16], bw,
                    kernels[name]))
    path = "kernel layer entry points at full width (phase 5)"
    return {name: ({"path": path, "launches": launches[name],
                    "calls": calls[name]}, worst[name], timings[name])
            for name in calls}


# Phase 6's run: the first CHAOS_REQUESTS requests of phase 3's
# shared-prefix trace, budgets capped at CHAOS_BUDGET (the audited run
# copies every packed tensor to the host once per step, so the trace is
# cut by its number of steps, never by its width), under the seeded
# chaos plan (every kind fires while slots are busy; its bitflip hits a
# bitmap).
CHAOS_REQUESTS, CHAOS_BUDGET = 4, 16
CHAOS_SEED, CHAOS_HORIZON = 2, 24


def chaos_trace(shared) -> list:
    """Phase 6's trace: the first ``CHAOS_REQUESTS`` requests of phase
    3's shared-prefix trace, budgets capped at ``CHAOS_BUDGET``."""
    return [dict(spec, max_new_tokens=min(spec["max_new_tokens"],
                                          CHAOS_BUDGET))
            for spec in shared["trace"][:CHAOS_REQUESTS]]


def corrupted_bitmap_check(device, gen, k: int = 2048, n: int = 2048,
                           rows=(1, 4, 64)) -> float:
    """K1 on a bitmap with one extra set bit, at olmo-1b's q/k/v/o
    shape: every tile shares one non-zero pattern, so every tile fills
    the budget, and one clear bit of the last tile's last row is set.
    The kernel then reads a slot past the budget, which it clamps as the
    plain version does: the outputs must agree and the card must raise
    no error.  Dense (sparsity 0.5) and sparse-walk (0.97) tiles; float32
    and bf16 X.  Returns the largest |kernel - plain|."""
    from repro_torch.kernels import ops
    from repro_torch.sparse import pack_bitmap
    worst = 0.0
    bk, bn = 128, 128
    for sparsity in (0.5, 0.97):
        mask = torch.rand(bk, bn, generator=gen, device=device) >= sparsity
        mask[-1, -1] = False                    # a clear bit to set
        w = torch.randn(k, n, generator=gen, device=device) * mask.repeat(
            k // bk, n // bn)
        bw = pack_bitmap(w, block=(bk, bn))
        assert bw.budget == int(mask.sum())
        bits = bw.packed_bits.clone()
        bits[-1, -1, -1, -1] |= 0x80            # column bn - 1, last row
        bad = dataclasses.replace(bw, packed_bits=bits)
        for m in rows:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(m, k, generator=gen, device=device).to(dt)
                out = ops.bitmap_spmm(x, bad, impl="cuda")
                ref = ops.bitmap_spmm(x, bad, impl="torch")
                sync()
                worst = max(worst, _compare(
                    f"corrupted bitmap, sparsity {sparsity}, M={m}", out,
                    ref, k, dt))
        print(f"  K1 on a corrupted bitmap ({k}x{n}, block {(bk, bn)}, "
              f"budget {bw.budget} filled by every tile, one extra bit in "
              f"the last row of the last tile; sparsity {sparsity}): equal "
              f"to the plain version's clamp, no CUDA error, M={list(rows)}")
    return worst


def scan_timer(eng) -> list:
    """Time every integrity scan of ``eng``'s auditor (each copies every
    packed tensor to the host for its CRC32); returns the list of
    seconds it fills."""
    seconds = []
    scan = eng.auditor.integrity_scan

    def timed():
        t0 = time.perf_counter()
        bad = scan()
        seconds.append(time.perf_counter() - t0)
        return bad

    eng.auditor.integrity_scan = timed
    return seconds


def launch_recorder(eng) -> list:
    """Record K1 launches per decode step and per prefill call of
    ``eng``, beside the count its packed leaves give at that moment (a
    quarantined leaf is served dense and launches nothing): a list of
    (call, quarantined tensors, launches, expected)."""
    from repro_torch.kernels import LAUNCHES
    calls = []

    def wrap(name, fn, prefill):
        def recorded(*args, **kw):
            want = per_step(eng, prefill=prefill)["bitmap_spmm"]
            n0 = LAUNCHES["bitmap_spmm"]
            out = fn(*args, **kw)
            calls.append((name, len(eng.quarantined),
                          LAUNCHES["bitmap_spmm"] - n0, want))
            return out
        return recorded

    eng._decode = wrap("decode", eng._decode, False)
    eng._prefill = wrap("prefill", eng._prefill, True)
    return calls


def scan_breakdown(eng) -> dict:
    """One pass of the integrity scan's work over ``eng``'s packed
    tensors, timed by part: the copies to the host, ``zlib.crc32`` over
    them, and the finite check on the card."""
    import zlib
    parts = dict.fromkeys(("copy_s", "crc_s", "finite_s"), 0.0)
    live = [bw for _, bw in eng.packed.leaves()]
    if eng.lm_weight is not None:
        live.append(eng.lm_weight)
    nbytes = 0
    for bw in live:
        crc = 0
        for t in (bw.packed_bits, bw.values, bw.row_start):
            t0 = time.perf_counter()
            host = t.contiguous().cpu().numpy()
            t1 = time.perf_counter()
            crc = zlib.crc32(host, crc)
            parts["copy_s"] += t1 - t0
            parts["crc_s"] += time.perf_counter() - t1
            nbytes += host.nbytes
        t0 = time.perf_counter()
        bool(torch.isfinite(bw.values).all())
        parts["finite_s"] += time.perf_counter() - t0
    return {**parts, "bytes": nbytes}


def telemetry_cost(base, trace, device, rounds: int = 2) -> None:
    """Wall per engine step of ``trace`` served with every telemetry
    output on against all off, no faults and no audit, in turns (off,
    on, on, off, ...), on ``base``'s weights and phase 6's knobs: what
    the spans, the event log and the trace cost the host step."""
    from repro_torch.serve import ServeEngine
    walls = {False: [], True: []}
    with tempfile.TemporaryDirectory() as out:
        for i in range(2 * rounds):
            on = i % 4 in (1, 2)
            files = ({"trace_out": f"{out}/t{i}.json",
                      "events_out": f"{out}/e{i}.jsonl",
                      "metrics_out": f"{out}/m{i}.json"} if on else {})
            eng = ServeEngine(base.cfg, num_slots=4, max_len=256,
                              params=base.params,
                              head_sparsity=base.head_sparsity, paged=True,
                              page_len=16, prefill_chunk=16,
                              prefix_reuse=True, preempt=True,
                              page_pool_tokens=160, device=device, **files)
            eng.warmup()
            for spec in trace:
                eng.submit(**spec)
            rep = eng.run()
            eng.close()
            walls[on].append(1e3 * rep["wall_s"] / rep["steps"])
            del eng
    off, on = walls[False], walls[True]
    print(f"telemetry cost, same trace in turns (off, on, on, off): wall "
          f"per step telemetry on {', '.join(f'{w:.2f}' for w in on)} ms "
          f"against off {', '.join(f'{w:.2f}' for w in off)} ms (mean "
          f"{sum(on) / len(on):.2f} against {sum(off) / len(off):.2f} ms)")


def strict_json(path: str):
    def refuse(token):
        raise ValueError(f"{path}: non-strict JSON constant {token}")
    with open(path) as f:
        return json.load(f, parse_constant=refuse)


def chaos_phase(base, shared, device, gen) -> dict:
    """Phase 6: olmo-1b at full width on phase 3's weights, trace and
    knobs (paged, pages of 16, prefix reuse, preemption, chunked prefill
    16, the 160-token pool) under the seeded chaos plan, with the
    auditor and every telemetry artifact.  Returns K1's path record."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serve import (FaultPlan, ServeEngine, validate_events,
                                   validate_trace)
    cfg = base.cfg
    corrupted_bitmap_check(device, gen)
    trace = chaos_trace(shared)
    reuse = shared["reuse"]
    want = {"tokens": [t[:spec["max_new_tokens"]] for t, spec in
                       zip(reuse["tokens"], trace)],
            "prompt_lens": reuse["prompt_lens"][:len(trace)]}
    with tempfile.TemporaryDirectory() as out:
        files = {"trace_out": f"{out}/trace.json",
                 "events_out": f"{out}/events.jsonl",
                 "metrics_out": f"{out}/metrics.json",
                 "traffic_out": f"{out}/traffic.json"}
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, num_slots=4, max_len=256, params=base.params,
                          head_sparsity=base.head_sparsity, paged=True,
                          page_len=16, prefill_chunk=16, prefix_reuse=True,
                          preempt=True, page_pool_tokens=160, audit=True,
                          faults=FaultPlan.chaos(CHAOS_SEED, CHAOS_HORIZON),
                          device=device, **files)
        assert_no_dense_copy(eng)
        built = time.perf_counter() - t0
        modeled0 = eng.traffic.report()["weight"]["sparse_bytes_per_step"]
        executed0 = executed_bytes(eng)
        eng.warmup()
        scans, calls = scan_timer(eng), launch_recorder(eng)
        rep = serve(eng, trace, "chaos + audit + telemetry engine")
        written = eng.close()
        assert sorted(written) == sorted(files.values()), written

        # faults: each kind fired while slots were busy; both
        # corruptions were found and quarantined
        fs, lc = rep["lifecycle"]["faults"], rep["lifecycle"]
        print(f"faults: {fs['fired']} of {fs['planned']} fired (seed "
              f"{fs['seed']}) | " + "; ".join(
                  f"step {e['step']} {e['kind']}"
                  + (f" {e['tensor']}" if e.get("tensor") else "")
                  + (f" {e['field']} bit {e['bit']}" if "bit" in e else "")
                  for e in fs["log"]))
        flips = [e for e in fs["log"] if e["kind"] == "bitflip"]
        assert fs["fired"] >= 4 and {"nan_logits", "bitflip"} <= set(
            fs["by_kind"]), fs
        assert "lm_head" in lc["quarantined"], lc["quarantined"]
        assert flips[0]["tensor"] in lc["quarantined"], lc["quarantined"]
        print(f"quarantined: {sorted(lc['quarantined'])} | audit "
              f"{lc['audit']}")
        for r in eng.requests:
            assert r.error is None, (r.rid, r.error)
        eng.kv.flush_prefix()
        eng.kv.audit()
        assert all(not p.ref and not p.held for p in eng.kv.pools.values())
        assert eng.report()["paging"]["pages_in_use"] == 0
        same_tokens_or_near_tie(rep, want, shared["margins"], cfg.d_model,
                                "chaos run vs phase 3's reuse + preempt")

        # K1 on every projection before and after each quarantine
        by_state = {}
        for name, q, got, expect in calls:
            assert got == expect, (name, q, got, expect)
            by_state.setdefault((name, q), set()).add(got)
        assert all(n > 0 for counts in by_state.values() for n in counts)
        assert sum(c[2] for c in calls) == rep["launches"]["bitmap_spmm"]
        print("K1 launches per call by quarantined tensors: " + "; ".join(
            f"{name} with {q} quarantined: {sorted(n)}"
            for (name, q), n in sorted(by_state.items())))

        # telemetry artifacts
        stats = validate_trace(files["trace_out"])
        assert stats["steps"] > 0 and stats["requests"] == len(trace) \
            and stats["agg_coverage"] > 0.5, stats
        n_events = validate_events(files["events_out"])
        assert n_events > 0
        metrics = strict_json(files["metrics_out"])
        assert metrics["schema"] == "repro.serve.metrics/v1"
        traffic = strict_json(files["traffic_out"])
        assert traffic["schema"] == "repro.serve.traffic/v1"
        reason = traffic["traffic"]["crosscheck"]["reason"]
        assert reason
        print(f"telemetry: trace {stats['steps']} steps, "
              f"{stats['requests']} requests, phase coverage "
              f"{stats['agg_coverage']:.3f} | {n_events} events | metrics "
              f"snapshot strict JSON, {len(metrics['metrics'])} metrics | "
              f"traffic artifact written, crosscheck: {reason}")

        # what the audit and the telemetry cost, and the ledger
        steps = eng.metrics.get("step.wall_s")
        wall_ms = 1e3 * steps.mean
        scan_ms = 1e3 * sum(scans) / len(scans)
        reuse_ms = 1e3 * reuse["wall_s"] / reuse["steps"]
        scanned = sum(bw.hbm_bytes for _, bw in eng.packed.leaves())
        print(f"integrity scan: {len(scans)} scans over {steps.count} steps,"
              f" {scan_ms:.1f} ms each (min {1e3 * min(scans):.1f}, max "
              f"{1e3 * max(scans):.1f}; the last copied {scanned / 1e9:.3f} "
              f"GB of packed tensors to the host) | step wall with "
              f"telemetry and audit {wall_ms:.1f} ms, "
              f"{wall_ms - scan_ms * len(scans) / steps.count:.1f} ms "
              f"without the scans, against {reuse_ms:.1f} ms per step in "
              f"phase 3's reuse + preempt run (telemetry off)")
        tr = rep["traffic"]
        dec = tr["phases"]["decode"]
        en, rl = tr["energy"], tr["roofline"]["decode"]
        print(f"ledger: decode weight bytes per step modeled "
              f"{modeled0 / 1e9:.4f} GB against K1's executed "
              f"{executed0 / 1e9:.4f} GB before any fault; over the run "
              f"{dec['weight_bytes'] / dec['steps'] / 1e9:.4f} GB per "
              f"decode step, executed now {executed_bytes(eng) / 1e9:.4f} "
              f"GB (quarantined tensors served dense) | KV read "
              f"{dec['kv_read_bytes'] / 1e6:.1f} MB, written "
              f"{dec['kv_write_bytes'] / 1e6:.1f} MB")
        print(f"energy, the paper's 28 nm accelerator model (Table I; not "
              f"this card): {en['pj_per_token'] / 1e6:.2f} uJ/token "
              f"({en['pj_per_token_dense'] / 1e6:.2f} dense), "
              f"{en['tops_per_watt']:.3f} TOPS/W "
              f"({en['tops_per_watt_dense']:.3f} dense)")
        busy = shared["busy_ms"]
        print(f"roofline (H100, 3.35 TB/s): decode memory_s "
              f"{1e3 * rl['memory_s']:.3f} ms per step ({rl['bottleneck']} "
              f"bound) against the device busy "
              + (f"{busy:.2f} ms" if busy is not None else "(not measured)")
              + " per step profiled in phase 3 (contiguous walk)")
        parts = scan_breakdown(eng)
        print(f"integrity scan by part, one pass over the "
              f"{parts['bytes'] / 1e9:.3f} GB still packed: copies to the "
              f"host {1e3 * parts['copy_s']:.1f} ms "
              f"({parts['bytes'] / parts['copy_s'] / 1e9:.2f} GB/s), "
              f"zlib.crc32 {1e3 * parts['crc_s']:.1f} ms "
              f"({parts['bytes'] / parts['crc_s'] / 1e9:.2f} GB/s), finite "
              f"check on the card {1e3 * parts['finite_s']:.1f} ms")
        print(f"[chaos run: engine {built:.1f}s, "
              f"{time.perf_counter() - t0:.1f}s in all]")
    record = {"path": f"{cfg.name}, paged, reuse + preempt, chaos + audit",
              "launches": rep["launches"]["bitmap_spmm"],
              "launches_per_step": per_step(base)["bitmap_spmm"],
              "launches_per_prefill_call": per_step(
                  base, prefill=True)["bitmap_spmm"],
              "decode_steps": eng.decode_steps,
              "prefill_calls": rep["prefill"]["calls"]}
    assert LAUNCHES["bitmap_spmm_grouped"] == 0
    del eng
    torch.cuda.empty_cache()
    return record


def lifecycle_pass(base, shared, device) -> None:
    """Phase 6's lifecycle pass on the same weights and knobs (default
    pool, ``max_queue`` 4): four requests at once, a fifth refused with
    ``ServeOverloaded``; one cancelled mid-decode, one cancelled while
    queued, one with a deadline of 20 of phase 3's step walls and a
    64-token budget that expires mid-flight.  The terminal states must
    partition the history and the pool must be whole afterwards."""
    from repro_torch.serve import (DeadlineExceeded, RequestState,
                                   ServeEngine, ServeOverloaded)
    t0 = time.perf_counter()
    reuse = shared["reuse"]
    deadline = 20e3 * reuse["wall_s"] / reuse["steps"]
    prompts = [spec["prompt"] for spec in shared["trace"]]
    eng = ServeEngine(base.cfg, num_slots=4, max_len=256, params=base.params,
                      head_sparsity=base.head_sparsity, paged=True,
                      page_len=16, prefill_chunk=16, prefix_reuse=True,
                      preempt=True, max_queue=4, device=device)
    eng.warmup()
    done = [eng.submit(prompts[0], 12), None]
    cancel_decoding = eng.submit(prompts[1], 40)
    expire = eng.submit(prompts[2], 64, deadline_ms=deadline)
    done[1] = eng.submit(prompts[3], 12)
    shed = 0
    try:
        eng.submit(prompts[4], 8)
    except ServeOverloaded as e:
        shed += 1
        print(f"lifecycle: submit refused, {e}")
    assert shed == 1
    eng.step()
    queued = eng.submit(prompts[4], 8, arrival=eng._steps)
    eng.step()
    assert queued.state is RequestState.WAITING
    assert eng.cancel(queued.rid)
    while (cancel_decoding.state is RequestState.ACTIVE
           and len(cancel_decoding.tokens) < 4):
        eng.step()
    assert eng.cancel(cancel_decoding.rid)
    rep = eng.run()
    lc = rep["lifecycle"]
    states = {r.rid: r.state.name for r in eng.requests}
    print(f"lifecycle: states {states} | tokens done "
          f"{[len(r.tokens) for r in done]}, cancelled mid-decode "
          f"{len(cancel_decoding.tokens)}, expired "
          f"{len(expire.tokens)} of 64 (deadline {deadline:.0f} ms), "
          f"cancelled queued {len(queued.tokens)} | counters cancelled "
          f"{lc['cancelled']} expired {lc['expired']} shed {lc['shed']} "
          f"wasted tokens {lc['wasted_tokens']}")
    assert all(r.state is RequestState.DONE and len(r.tokens) == 12
               for r in done)
    assert cancel_decoding.state is RequestState.CANCELLED
    assert 4 <= len(cancel_decoding.tokens) < 40
    assert queued.state is RequestState.CANCELLED and not queued.tokens
    assert expire.state is RequestState.EXPIRED
    assert isinstance(expire.error, DeadlineExceeded)
    assert 0 < len(expire.tokens) < 64, len(expire.tokens)
    tax = lc["terminal_states"]
    assert sum(tax.values()) == len(eng.requests) == 5, tax
    assert tax == {"DONE": 2, "CANCELLED": 2, "EXPIRED": 1}, tax
    assert (lc["cancelled"], lc["expired"], lc["shed"]) == (2, 1, 1), lc
    assert lc["wasted_tokens"] == (len(cancel_decoding.tokens)
                                   + len(expire.tokens))
    eng.kv.flush_prefix()
    eng.kv.audit()
    assert all(not p.ref and not p.held for p in eng.kv.pools.values())
    assert eng.report()["paging"]["pages_in_use"] == 0
    print(f"lifecycle: terminal states partition the history, pool whole "
          f"[{time.perf_counter() - t0:.1f}s]")
    del eng
    torch.cuda.empty_cache()


def phase(label: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[{label}: {now - t0:.1f}s]")
    return now


def run(olmo_cfg, granite_cfg, gemma_cfg, device, gen,
        olmo_shapes=OLMO_SHAPES, granite_shapes=GRANITE_SHAPES,
        expert_shapes=GRANITE_EXPERT_SHAPES, attn=None,
        rows=MATMUL_ROWS, timed_rows=(4, 2048)) -> dict:
    """Phases 2-5; returns the kernels record.  A kernel's ``launches``
    sums its ``paths`` (each path's run with the counts set to 0 just
    before it).  K1's and K1g's ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are one decode step's calls at M = 4; K2's are
    olmo-1b's bf16 causal shape and K3's / K4's the gate/up weight at
    M = 4, with every timed shape under ``timings`` (``ms_scope``)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    t = time.perf_counter()
    worst = {"bitmap_spmm": max(
        kernel_against_plain(device, gen, olmo_shapes, ROWS, SPARSITIES),
        kernel_against_plain(device, gen, granite_shapes, GRANITE_ROWS,
                             GRANITE_SPARSITIES))}
    worst["bitmap_spmm_grouped"] = max(
        kernel_against_plain(device, gen, expert_shapes, GRANITE_ROWS,
                             GRANITE_SPARSITIES,
                             groups=granite_cfg.num_experts),
        grouped_edge_cases(device, gen, expert_shapes, GRANITE_ROWS,
                           granite_cfg.num_experts))
    print(f"kernels against plain: {dict(LAUNCHES)} comparison launches, "
          f"max |kernel - plain| {worst}")
    reset_launches()
    t = phase("phase 2, kernels against plain", t)

    olmo, olmo_paths, shared = olmo_engine_phase(olmo_cfg, device, gen)
    olmo_times = olmo_timing_phase(olmo, device, gen)
    torch.cuda.empty_cache()
    t = phase(f"phase 3, {olmo_cfg.name}", t)

    eng, granite_paths = granite_engine_phase(granite_cfg, device, gen)
    g_times, whole = granite_timing_phase(eng, device, gen)
    del eng
    torch.cuda.empty_cache()
    t = phase(f"phase 4, {granite_cfg.name}", t)

    layer = kernel_layer_phase(olmo_cfg, gemma_cfg, device, gen, attn=attn,
                               rows=rows, timed_rows=timed_rows)
    for name, (_, err, _) in layer.items():
        worst[name] = err
    t = phase("phase 5, kernels K2-K4 against their plain versions and "
              "timed", t)

    chaos_path = chaos_phase(olmo, shared, device, gen)
    telemetry_cost(olmo, chaos_trace(shared), device)
    lifecycle_pass(olmo, shared, device)
    del olmo
    torch.cuda.empty_cache()
    phase(f"phase 6, {olmo_cfg.name} under faults, audit and telemetry", t)

    def record(name, paths, times, scope, **extra):
        ms, plain_ms, b_ms, by, lib_ms = times
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": sum(p["launches"] for p in paths),
                "paths": paths, "max_abs_err": worst[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": lib_ms, "ms_scope": scope, **extra}

    k1_paths = ([p["bitmap_spmm"] for p in olmo_paths] + [chaos_path]
                + [p["bitmap_spmm"] for p in granite_paths])
    k1g_paths = [p["bitmap_spmm_grouped"] for p in granite_paths]
    g1 = g_times["bitmap_spmm"]
    return {"kernels": [
        record("bitmap_spmm", k1_paths, olmo_times,
               f"one {olmo_cfg.name} decode step: "
               f"{k1_paths[0]['launches_per_step']} launches at M=4",
               granite={"ms": g1[0], "plain_ms": g1[1], "bound_ms": g1[2],
                        "bound_by": g1[3], "library_ms": g1[4],
                        "ms_scope": f"one {granite_cfg.name} decode step: "
                                    f"{k1_paths[-1]['launches_per_step']} "
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
                                       "decode step"})] + [
        record(name, [path], tuple(timings[0][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")),
            f"{timings[0]['shape']}, bf16; library "
            f"{timings[0]['library']}", timings=timings)
        for name, (path, _, timings) in layer.items()]}


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
                 get_config("gemma3-4b"), torch.device("cuda"), gen)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s"
          f" on {smi} (the kernels line: launches over the main-path runs; "
          f"times per decode step for K1 and K1g, per call for K2-K4)")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

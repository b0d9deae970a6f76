#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Card and build: prints the card's name and power limit, then builds
   every CUDA source in ``src/repro_torch/kernels/csrc`` for ``sm_90a``
   (one ``nvcc`` per source, all at once, linked into one library with
   six entry points: ``bitmap_spmm``, ``bitmap_spmm_grouped``,
   ``flash_attention``, ``block_sparse``, ``nm_spmm`` and
   ``decode_attention``; registers, shared memory and spills from
   ptxas).  For each variant of K1 / K1g, K2 (path x head dim x type),
   K3 / K4 and decode attention it prints its registers,
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
   bit-identical outputs; then K1 at the recurrent mixers' shapes
   (rwkv6-3b's time-mix, mix_A at BN 80, decay_A, decay_B, channel-mix
   and head; jamba's mamba in_proj, x_proj at BN 96, dt_proj, out_proj;
   jamba smoke's dt_proj at BK 4) and K1g at rwkv6-3b's 5-group mix_B
   (32, 2560), rows M in {1, 4, 64}, weights pruned to {0, 0.5, 0.95};
   then sharded weights (``shard_bitmap``, 2 shards, tiles chosen
   against a shard's slice): K1 on olmo-1b's wq (col), w_down (row) and
   head (col, BN 96), K1g on granite's expert gate/up (col) and down
   (row), each product one launch per shard (``ops._sharded_spmm``)
   against the plain version of the unsharded weight, M in {1, 4};
   float32 and bfloat16 X; atol 2e-3·√K (float32) / 2e-2·√K (bfloat16),
   rtol 1e-2.
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
   share under ``torch.profiler``.  Last, one decode step of the walk
   engine with baseline mode's MoE dispatch (``moe_global``, as a step
   built under ``REPRO_PERF_MODE=baseline`` runs it): every MoE layer
   through the global dispatch (``layers._moe_ffn_global``, the whole
   slot batch ranked at once),
   96 K1g and 160 K1 launches, the logits against the plain versions
   (phase 3's rule).
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

5b. Decode attention (``ops.decode_attention``) at the served shapes,
   bf16: olmo-1b as the longgen cell serves it (B 64, C 2048, 16 heads,
   D 128, positions 0-2047), granite-moe-3b-a800m as the batch cell (B
   256, C 1024, 24 / 8 heads, D 64, positions 16-200) and gemma3-4b's
   local layers (B 64, a ring of one 1024 window, 8 / 4 heads, D 256,
   positions 0-4095: cold ring lines).  Each output within phase 5's
   limit of the plain version (per (slot, head) row), a second call
   bit-equal, one launch counted per call; then timed as CUDA-graph
   replays beside its bound (the valid K / V lines' bytes, q and the
   output once, over 3.35 TB/s), the plain version and
   ``scaled_dot_product_attention`` over the whole cache with the valid
   lines as its mask (a yardstick; the port never calls it).  Every
   engine path of phases 3-13 also counts one decode-attention launch
   per attention layer per decode step and per chunk token of a
   prefill call.
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
7. The recurrent mixers.  rwkv6-3b on the full configuration (32
   layers, full widths, seeded random weights) at sparsity 0.5, 4 slots,
   ``max_len`` 256, serving 8 requests of a seeded Poisson trace
   (prompts of 4-16 tokens, walked; budgets 16-32): every request served
   its whole budget, K1 launched 11 × 32 + 1 = 353 times and K1g
   (``mix_B``) 32 times per decode step, each fallback's reason printed,
   no dense copy of a packed weight, one decode step's logits through
   the kernels agreeing with the plain version (phase 3's rule), and a
   second decode step from the same state giving bit-identical logits
   and state; then K1's and K1g's launches of one step timed against
   their byte bound, and the profiled idle share.  Then one mamba block
   at jamba's full widths (d 4096, dI 8192, N 16, dt_rank 256), pruned
   to 0.5, stepped 8 times at M = 4 through K1 against the plain
   version.  Then jamba's hybrid wiring at smoke widths only (jamba
   does not fit one card at full width): its engine on the contiguous
   cache and paged with recompute-on-preempt on a 48-token pool
   (preemptions required) serve the same tokens.
8. Training on the card.  (a) olmo-1b at full width (16 layers, d 2048,
   d_ff 8192, vocab 50304, tied head: 1.18 B parameters), seeded init,
   ``global_l1_prune(0.5)`` with its masks, remat as configured, AdamW
   (lr 3e-4, warmup 2, ``total_steps`` 12), batch 4 x seq 512 from
   ``synth_batch`` (seed 0), 12 steps: 2 warm-up, 8 timed, 2 under
   ``torch.profiler``.  Every loss and grad norm finite, the first loss
   within 2.5 of ln(V), every pruned element exactly 0 after every
   step, the blocks' sparsity >= 0.499 (the embedding is not prunable).
   It prints the median ms per step, tokens/s, model FLOP/s and MFU
   against 989 TFLOP/s (6·N·T plus the attention term; the remat
   recompute apart), the peak memory and the idle share.  No checkpoint
   of it is written.  (b) olmo-1b, granite-moe-3b-a800m, gemma3-4b,
   rwkv6-3b and jamba-v0.1-52b at smoke widths: one train step's loss
   and gradients on the card against the CPU's from the same params
   (float32; loss within 1e-5 relative, each gradient leaf within
   1e-4·max|CPU| + 1e-7), then olmo smoke trained 6 steps with a
   checkpoint at 3, its last checkpoint dropped and the run resumed:
   bit-equal to an uninterrupted run.  (c) K2 forward against the
   training path's ``scan_attention`` at (a)'s attention shape (B 4, 16
   heads, S 512, D 128, causal), bf16 and float32, phase 5's limits;
   nothing on the training path calls K2.  (d) (a)'s params, its
   optimizer state freed, packed (``pack_model``, ``pack_lm_head``) and
   served: 4 requests, prompts from the synthetic stream, budgets 16,
   walked; every budget served, 113 K1 launches per decode step, no
   dense copy, one decode step through K1 against the plain step.
9. Sharded serving over ``torch.distributed``: full-width olmo-1b
   (params from seed 9), sparsity 0.5, 4 slots, 4 Poisson requests of
   8 new tokens walked, served first by the one-rank engine here, then
   by a world of 2 ranks (this script with ``--phase9-rank``): gloo,
   both ranks on this card (and NCCL, a card per rank, where the host
   has 2 cards or more).  (a) ``model_parallel=2``, contiguous: the
   packed stack and the vocabulary-split head sharded, each rank
   holding its part; (b) ``model_parallel=1``, paged with
   ``kv_shards=2``: the page pools sharded.  Tokens equal to the
   one-rank run's exactly, the gathered stack and head byte-equal to
   the unsharded packs (CRC32), 113 K1 launches per decode step on each
   rank, each rank's resident packed bytes about half the one-rank
   figure (manifest and ``memory_allocated``); the dense params stored
   by ``param_specs`` (each rank holds the whole tree less half its
   model-sharded leaves) and, with no quarantine, no dense leaf gathered;
   it prints the step wall, the gather's ms and bytes received per step
   (the dense part apart), the resident packed and dense bytes and the
   peak memory per rank and the backend.  A rank that fails fails the
   run.
10. Sharded training over ``torch.distributed``: full-width olmo-1b
   (phase 8a's seeded init, ``global_l1_prune(0.5)`` and its masks,
   batch 4 x 512 from ``synth_batch``, AdamW lr 3e-4, warmup 2) in a
   world of 2 ranks (this script with ``--phase10-rank``): gloo, both
   ranks on this card (and NCCL, a card per rank, where the host has 2
   cards or more).  Rank 0 first trains the one-rank step twice from the
   same state.  (a) (data 1, model 2), 2 steps
   (``build_train_step_spmd``): losses and the gathered params bit-equal
   to the one-rank run's; (b) (data 2, model 1), ZeRO-1 moments, 2
   steps: losses within 1e-3 and params within 5e-3 (the bf16 backward
   over half batches rounds differently).  Both: every pruned element
   exactly 0 on every rank, the resident params about half of one
   rank's in (a) and the moments about half in (b).  Then
   ``compressed_psum_grads`` over the 2 ranks on a 16 M-element float32
   gradient against the CPU formula within one quantum.  It prints per
   run the step ms, the gather and all-reduce ms and bytes received per
   step, the resident bytes and peak memory per rank and the backend.
   Training reaches no kernel: the kernels line gains no launch.  A rank
   that fails fails the run.
11. musicgen-medium, the frames frontend, at full width (48 layers, d
   1536, d_ff 6144, vocab 2048: 1.365 B params; no cut): seeded init,
   sparsity 0.5, 4 slots, ``max_len`` 256.  First the frames key on the
   card: the key folded at steps 0, 1, 17 and 10**6, its bits and
   normals against the same replay on the CPU (keys and bits exact,
   normals within 4 ulps).  Then 8 Poisson requests walked, contiguous:
   every budget served, 6 x 48 + 1 = 289 K1 launches per decode step,
   no dense copy, one decode step (the engine's own frame draw) through
   the kernels against the plain versions (phase 3's rule); then paged
   (pages of 16) with prefix reuse, preemption and chunked prefill
   asked, each falling back with the reference's frames reason: the
   same counts, and tokens equal to the contiguous run's or parting
   only at its near tie.  It prints tok/s, p50 / p99, ms per step, K1's
   289 launches of one step against their byte bound, the profiled idle
   share and the peak memory.
12. The port's examples through their ``main`` with default arguments
   (``examples/torch/``: quickstart, serve_batched, train_sparse_lm),
   each printing ``OK``; their K1 / K1g launches are counted and join
   the kernels line.
13. olmo-1b at full width again (sparsity 0.5, 4 slots, ``max_len``
   256), serving sampled requests: (a) a seeded Poisson trace of 8
   requests, every other one sampled (T 0.8 / 1.0, per-request top-k 0
   / 40, seeds of their own), contiguous then paged (pages of 16):
   every budget served, 113 K1 launches per decode step, beside the
   same trace all greedy on an engine of the same weights; then one
   decode step with four set slots (two sampled at top-k 0 and 40, one
   at top-k 3, one greedy): the keys folded on the card equal the CPU
   replay's, their Gumbel bits equal, the Gumbel values within 1e-6,
   and every sampled token equal to argmax(logits / T + gumbel) over
   the slot's top-k (greedy: argmax), the Gumbel values replayed on the
   CPU; one decode step through the kernels against the plain versions
   (phase 3's rule).  (b) ``eng.traffic.crosscheck()`` with the card's
   dispatch: the decode step counted on meta tensors, its bytes against
   the modeled floor and the reference's band (1, 8), and the same step
   executed under the counter, equal op for op to the meta count.  (c)
   That decode step as a one-rank dry-run cell (``dryrun.count_cell``
   on meta copies): its peak bytes beside ``max_memory_allocated`` of
   the executed step after ``reset_peak_memory_stats``, and the gap.
   (d) ``python -m repro_torch.launch.dryrun --arch olmo-1b --shape
   decode_32k`` on the host (a fake world of 256 ranks, meta tensors):
   its record line and seconds.

Bounds are the larger of the bytes a call must move over 3.35 TB/s and
its operations over 989 TFLOP/s (bf16), with this run's non-zeros, live
score pairs (K2), surviving blocks (K3) or kept values (K4).  The
line before the last is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
# the recurrent mixers' K1 shapes: rwkv6-3b's time-mix (r/k/v/g/o; mix_A,
# BN 80; decay_A; decay_B, whose X is float32), channel-mix and head,
# then jamba's mamba in_proj, x_proj (BN 96), dt_proj, out_proj, and
# jamba smoke's dt_proj (BK 4); K1g: rwkv6-3b's 5-group mix_B
SSM_SHAPES = (("rwkv w_rkvgo", 2560, 2560), ("rwkv mix_A", 2560, 160),
              ("rwkv decay_A", 2560, 64), ("rwkv decay_B", 64, 2560),
              ("rwkv cm_k", 2560, 8960), ("rwkv cm_v", 8960, 2560),
              ("rwkv head", 2560, 65536), ("mamba in_proj", 4096, 16384),
              ("mamba x_proj", 8192, 288), ("mamba dt_proj", 256, 8192),
              ("mamba out_proj", 8192, 4096), ("smoke dt_proj", 4, 128))
MIX_B_SHAPES = (("rwkv mix_B", 32, 2560),)
SSM_ROWS = (1, 4, 64)
SSM_SPARSITIES = (0.0, 0.5, 0.95)
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
           "nm_spmm": CSRC + "nm_spmm.cu",
           "decode_attention": CSRC + "decode_attention.cu"}
REPLACES = {"bitmap_spmm": "src/repro/kernels/bitmap_spmm.py:74",
            "bitmap_spmm_grouped": "src/repro/kernels/bitmap_spmm.py:167",
            "flash_attention": "src/repro/kernels/flash_attention.py:69",
            "block_sparse_matmul": "src/repro/kernels/block_sparse.py:49",
            "nm_spmm": "src/repro/kernels/nm_spmm.py:52",
            # no Pallas kernel: the einsums XLA fuses
            "decode_attention": "src/repro/models/layers.py:171"}


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
                                     decode_attention, flash_attention,
                                     nm_spmm)
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
               nm_spmm._entry(), decode_attention._entry()]
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
    ("decode attention", "decode_attention", None, 0),
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


def attention_calls(eng, prefill: bool = False) -> int:
    """Decode-attention launches one decode step (or one prefill call:
    one per chunk token) makes: one per attention layer."""
    cfg = eng.cfg
    layers = sum(b.mixer == "attn" for b in cfg.pattern) * cfg.num_periods
    return layers * (eng.prefill_chunk if prefill else 1)


def no_weight_kernel(launches: dict) -> bool:
    """No product kernel launched (decode attention is the model's, not
    the weights' dispatch)."""
    return sum(n for k, n in launches.items()
               if k != "decode_attention") == 0


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
    decode step and prefill call (decode attention's too); returns the
    path's record."""
    expect, per_call = per_step(eng), per_step(eng, prefill=True)
    expect["decode_attention"] = attention_calls(eng)
    per_call["decode_attention"] = attention_calls(eng, prefill=True)
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
    from repro_torch.prng import fold_in, normal
    cfg, device = eng.cfg, eng.device
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                        device=device)
    embeds = None
    if cfg.frontend == "frames":
        # the engine's own draw at step 5: frame embeddings, no tokens
        tok, embeds = None, normal(fold_in(eng._embed_key, 5),
                                   (4, 1, cfg.d_model), device)
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
                                   embeds=embeds, lm_weight=eng.lm_weight,
                                   packed=eng.packed.blocks, lm_impl=impl,
                                   page_tables=tables)
        del cache
    sync()
    assert out[None].shape == (4, cfg.vocab_size)
    agree(out[None], out["torch"],
          "paged decode-step logits" if tables else "decode-step logits")


def baseline_decode_check(eng, gen) -> dict:
    """Phase 4: one decode step of ``eng`` with baseline mode's MoE
    dispatch (``moe_global``, what a step built under
    ``REPRO_PERF_MODE=baseline`` passes: the whole slot batch's tokens
    ranked at once, ``layers._moe_ffn_global``) through the kernels
    against the plain versions, phase 3's rule.  Returns the step's
    launches by kernel (K1g one per expert stack per layer, as the
    default dispatch; decode attention one per attention layer)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import layers
    from repro_torch.models.model import decode_step
    cfg, device = eng.cfg, eng.device
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                        device=device)
    pos = torch.tensor([3, 17, 64, 200], device=device)
    dispatched = []
    real = layers._moe_ffn_global

    def counted(*a, **kw):
        dispatched.append(1)
        return real(*a, **kw)

    layers._moe_ffn_global = counted
    try:
        out, launches = {}, {}
        for impl in (None, "torch"):
            cache = {b: {k: t.clone() for k, t in leaf.items()}
                     for b, leaf in eng.kv.cache.items()}
            sync()
            reset_launches()
            out[impl], _ = decode_step(eng.params, cache, cfg, tok, pos,
                                       lm_weight=eng.lm_weight,
                                       packed=eng.packed.blocks,
                                       lm_impl=impl, moe_global=True)
            sync()
            launches[impl] = dict(LAUNCHES)
            del cache
    finally:
        layers._moe_ffn_global = real
    reset_launches()
    want = per_step(eng)
    got = {k: launches[None][k] for k in want}
    assert got == want, (got, want)
    assert sum(launches["torch"].values()) == 0, launches["torch"]
    got["decode_attention"] = launches[None]["decode_attention"]
    assert got["decode_attention"] == attention_calls(eng), got
    moe_blocks = sum(b.ffn == "moe" for b in cfg.pattern) * cfg.num_periods
    assert len(dispatched) == 2 * moe_blocks, (len(dispatched), moe_blocks)
    agree(out[None], out["torch"],
          "baseline-mode decode-step logits (global MoE dispatch)")
    print(f"baseline mode: {got['bitmap_spmm_grouped']} K1g + "
          f"{got['bitmap_spmm']} K1 launches in one decode step, "
          f"{moe_blocks} MoE layers through the global dispatch")
    return got


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


def profile_device(run_fn, steps: int):
    """Kernels of ``steps`` calls of ``run_fn`` under torch.profiler:
    ([(name, device us summed over the steps)], wall us of the steps), or
    None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    if not sum(t for _, t in kernels):
        print("profiler: no device time seen; idle share not measured")
        return None
    return kernels, wall_us


def profile_steps(eng, steps: int = 6):
    """Device busy share of full-batch decode steps (torch.profiler):
    kernel time summed per name over the steps' wall time.  Returns the
    device's busy ms per step, or None when the profiler saw no device
    time."""
    for i in range(eng.num_slots):
        eng.submit([1 + i], max_new_tokens=steps + 4, arrival=eng._steps)
    for _ in range(2):
        eng.step()
    profiled = profile_device(eng.step, steps)
    eng.run()
    if profiled is None:
        return None
    kernels, wall_us = profiled
    busy_us = sum(t for _, t in kernels)
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
    assert no_weight_kernel(drep["launches"]), drep["launches"]
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
    call with dense weights in X's type (bf16, float32 for rwkv's
    decay_B)."""
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
    dense = [unpack_bitmap_stacked(w).to(x.dtype) for x, w, _ in seq]
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
    assert no_weight_kernel(drep["launches"]), drep["launches"]
    print(f"tok/s packed {rep['tok_per_s']:.1f} vs dense-dispatch "
          f"{drep['tok_per_s']:.1f}")
    del dense
    torch.cuda.empty_cache()
    profile_steps(eng)
    baseline = baseline_decode_check(eng, gen)
    return eng, paths, baseline


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
                        "decode_attention": 0, **calls}, (launches, calls)
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


def decode_attention_cases(olmo_cfg, granite_cfg, gemma_cfg):
    """Phase 5b's shapes, from the configs: (label, B, C, Hq, Hkv, D,
    window, ring, lowest and highest position), each slot's position
    drawn uniformly between the two.  olmo-1b as the longgen cell serves
    it (positions over the whole cache), granite-moe as the batch cell
    (prompts of 16-64 and up to ~140 generated), gemma3-4b's local
    layers (a ring of one window, positions up to four windows: a
    quarter of the slots have cold lines)."""
    window = next(b.window for b in gemma_cfg.pattern if b.window)

    def heads(cfg):
        return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    return [(f"{olmo_cfg.name} longgen", 64, 2048, *heads(olmo_cfg), None,
             False, 0, 2047),
            (f"{granite_cfg.name} batch", 256, 1024, *heads(granite_cfg),
             None, False, 16, 200),
            (f"{gemma_cfg.name} local ring", 64, window, *heads(gemma_cfg),
             window, True, 0, 4 * window - 1)]


def time_decode_attention(label, q, kc, vc, pos, window, ring):
    """Decode attention at one shape: kernel and SDPA (over the whole
    cache, the valid lines as its boolean mask) as CUDA-graph replays,
    input sets cycled past the L2; the plain version eagerly.  Bound:
    the valid K and V lines, q and the output once."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import valid_lines
    b, c, hkv, d = kc.shape
    hq = q.shape[2]
    valid = valid_lines(pos, c, window, ring)
    lines = int(valid.sum())
    moved = (2 * lines * hkv * d * kc.element_size()
             + 2 * q.numel() * q.element_size())
    b_ms, by = bound_ms(moved, 4 * hq * d * lines)
    sets = [(q, kc, vc)] + [tuple(t.clone() for t in (q, kc, vc))
                            for _ in range(_copies(moved) - 1)]
    t_k = graph_ms(lambda: [ops.decode_attention(*s, pos, window=window,
                                                 ring=ring)
                            for s in sets], 10) / len(sets)
    t_p = time_ms(lambda: ops.decode_attention(q, kc, vc, pos, impl="torch",
                                               window=window, ring=ring), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    args = {"attn_mask": valid[:, None, None, :],
            **({"enable_gqa": True} if hq != hkv else {})}
    lib = [tuple(t.transpose(1, 2) for t in s) for s in sets]
    t_l = graph_ms(lambda: [sdpa(*s, **args) for s in lib], 10) / len(lib)
    lib_err = (sdpa(*lib[0], **args).transpose(1, 2).float()
               - ops.decode_attention(q, kc, vc, pos, window=window,
                                      ring=ring).float()).abs().max().item()
    backend = _sdpa_backend(*lib[0], args)
    print(f"  decode attention {label} q {tuple(q.shape)} cache "
          f"{tuple(kc.shape)} window {window} ring {ring}: kernel "
          f"{t_k:.4f} ms | bound {b_ms:.4f} ms ({by}; {lines} valid lines of "
          f"{b * c}, {moved / 1e6:.1f} MB) = {100 * b_ms / t_k:.1f}% | "
          f"{moved / t_k / 1e6:.0f} GB/s | plain {t_p:.4f} ms | SDPA "
          f"({backend}, whole cache) {t_l:.4f} ms, max |SDPA - kernel| "
          f"{lib_err:.3g}")
    del sets, lib
    return {"shape": label, "window": window, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": by, "library_ms": t_l,
            "library": f"scaled_dot_product_attention ({backend})",
            "valid_lines": lines, "gb_per_s": moved / t_k / 1e6}


def decode_attention_phase(olmo_cfg, granite_cfg, gemma_cfg, device, gen,
                           cases=None) -> dict:
    """Phase 5b: decode attention (``ops.decode_attention``) at the
    served shapes, bf16, each output against the plain version on the
    same inputs (phase 5's limit, per (slot, head) row), a second call
    bit-equal to the first, then timed.  Returns {"decode_attention":
    (path record, max |kernel - plain|, timings)}."""
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    cases = cases or decode_attention_cases(olmo_cfg, granite_cfg,
                                            gemma_cfg)
    bf16 = torch.bfloat16
    worst, timings, launches = 0.0, [], 0
    for label, b, c, hq, hkv, d, window, ring, lo, hi in cases:
        q = torch.randn(b, 1, hq, d, generator=gen, device=device).to(bf16)
        kc, vc = (torch.randn(b, c, hkv, d, generator=gen,
                              device=device).to(bf16) for _ in range(2))
        pos = torch.randint(lo, hi + 1, (b,), generator=gen, device=device)
        sync()
        reset_launches()
        out = ops.decode_attention(q, kc, vc, pos, window=window, ring=ring)
        again = ops.decode_attention(q, kc, vc, pos, window=window,
                                     ring=ring)
        ref = ops.decode_attention(q, kc, vc, pos, impl="torch",
                                   window=window, ring=ring)
        sync()
        assert LAUNCHES["decode_attention"] == 2, (label, dict(LAUNCHES))
        launches += LAUNCHES["decode_attention"]
        assert torch.equal(out, again), label
        rms = ref.float().square().mean(-1, keepdim=True).sqrt()
        name = f"decode attention {label} {tuple(kc.shape)}"
        err, used, zero = scaled_compare(name, out, ref, ATTN_ATOL[bf16],
                                         rms)
        worst = max(worst, err)
        print(f"  {name}: max |kernel - plain| {err:.3g}, {used:.3g} of the "
              f"limit; a zero output fails at {100 * zero:.1f}% of the "
              f"non-zero elements; two calls bit-equal")
        del out, again, ref, rms
        timings.append(time_decode_attention(label, q, kc, vc, pos, window,
                                             ring))
        del q, kc, vc
        torch.cuda.empty_cache()
    reset_launches()
    path = {"path": "decode attention at the served shapes (phase 5b)",
            "launches": launches, "calls": launches}
    return {"decode_attention": (path, worst, timings)}


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
    auditor and every telemetry artifact.  Returns K1's and decode
    attention's path records by kernel."""
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
        # decode attention: one launch per attention layer per decode
        # call and per chunk token of a prefill call, quarantine or not
        n_calls = {kind: sum(c[0] == kind for c in calls)
                   for kind in ("decode", "prefill")}
        attn = {"decode": attention_calls(base),
                "prefill": attention_calls(eng, prefill=True)}
        assert rep["launches"]["decode_attention"] == sum(
            attn[k] * n for k, n in n_calls.items()), (rep["launches"],
                                                       n_calls, attn)

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
        cx = traffic["traffic"]["crosscheck"]["decode"]
        assert cx["compiled_bytes"] > 0 and cx["compiled_flops"] > 0
        reason = (f"decode counted/modeled {cx['ratio']:.3f} in "
                  f"{cx['tolerance']}")
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
    label = f"{cfg.name}, paged, reuse + preempt, chaos + audit"
    records = {"bitmap_spmm": {
        "path": label, "launches": rep["launches"]["bitmap_spmm"],
        "launches_per_step": per_step(base)["bitmap_spmm"],
        "launches_per_prefill_call": per_step(
            base, prefill=True)["bitmap_spmm"],
        "decode_steps": eng.decode_steps,
        "prefill_calls": rep["prefill"]["calls"]}, "decode_attention": {
        "path": label, "launches": rep["launches"]["decode_attention"],
        "launches_per_step": attn["decode"],
        "launches_per_prefill_call": attn["prefill"],
        "decode_steps": n_calls["decode"],
        "prefill_calls": n_calls["prefill"]}}
    assert LAUNCHES["bitmap_spmm_grouped"] == 0
    del eng
    torch.cuda.empty_cache()
    return records


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


# Phase 7's rwkv6-3b run: 8 requests of a seeded Poisson trace, prompts
# of 4-16 tokens (walked: recurrent state has no chunked prefill) and
# budgets of 16-32, on 4 slots.
SSM_TRACE = dict(n_requests=8, rate=0.5, seed=0, prompt_len=(4, 16),
                 max_new=(16, 32))


def fallback_reasons(eng) -> dict:
    """{reason: period-stacked tensors} of the manifest's dense rows."""
    out: dict = {}
    for e in eng.packed.fallback_entries:
        out[e.reason] = out.get(e.reason, 0) + 1
    return out


def same_state_twice(eng, gen) -> None:
    """One decode step through the kernels, twice from the same copy of
    the engine's state (its cache after serving): the logits and every
    new state leaf (rwkv ``s`` / ``x_prev`` / ``cm_x_prev``, mamba ``h`` /
    ``conv``, KV lines) must be bit-identical, so the in-place state
    writes are deterministic."""
    from repro_torch.models.model import decode_step
    cfg, device = eng.cfg, eng.device
    tok = torch.randint(0, cfg.vocab_size, (eng.num_slots, 1), generator=gen,
                        device=device)
    pos = torch.arange(eng.num_slots, device=device) * 5 + 3
    runs = []
    for _ in range(2):
        cache = {b: {k: t.clone() for k, t in leaf.items()}
                 for b, leaf in eng.kv.cache.items()}
        logits, cache = decode_step(eng.params, cache, cfg, tok, pos,
                                    lm_weight=eng.lm_weight,
                                    packed=eng.packed.blocks)
        runs.append((logits, cache))
    sync()
    (la, ca), (lb, cb) = runs
    assert torch.equal(la, lb), "logits differ between two runs"
    for b, leaf in ca.items():
        for k, t in leaf.items():
            assert torch.equal(t, cb[b][k]), (b, k)
    print(f"{cfg.name}: a second decode step from the same state gave "
          f"bit-identical logits and state "
          f"({', '.join(k for leaf in ca.values() for k in leaf)}, each "
          f"over {cfg.num_periods} layers)")


def rwkv_engine_phase(cfg, device, gen):
    """Phase 7 (rwkv6-3b serving).  Returns the engine and its path
    record."""
    from repro_torch.serve import ServeEngine, poisson_trace
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, num_slots=4, max_len=256, sparsity=0.5, seed=0,
                      device=device)
    ws = eng.weight_stream_report()
    print(f"engine {cfg.name}: init {eng.init_s:.2f}s, prune + pack "
          f"{eng.pack_s:.2f}s (constructor {time.perf_counter() - t0:.2f}s)"
          f" | weight sparsity {eng.weight_sparsity:.4f} | head compression"
          f" {eng.head_compression:.3f}x | max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"weight bytes per decode step: modeled "
          f"{ws['sparse_bytes_per_step'] / 1e9:.3f} GB packed (dense "
          f"{ws['dense_bytes_per_step'] / 1e9:.3f} GB) | executed "
          f"{executed_bytes(eng) / 1e9:.3f} GB")
    for reason, n in fallback_reasons(eng).items():
        print(f"  fallback, {n} period-stacked tensors: {reason}")
    assert_no_dense_copy(eng)
    want = per_step(eng)
    if cfg.name == "rwkv6-3b":
        assert want == {"bitmap_spmm": 11 * 32 + 1,
                        "bitmap_spmm_grouped": 32}, want
    trace = poisson_trace(vocab_size=cfg.vocab_size, **SSM_TRACE)
    rep = serve(eng, trace, f"{cfg.name} packed engine, prompt walk")
    path = check_counts(eng, rep, f"{cfg.name}, prompt walk")
    print(f"{cfg.name}: {rep['tok_per_s']:.2f} tok/s | latency p50 "
          f"{rep['latency_s']['p50'] * 1e3:.1f} ms p99 "
          f"{rep['latency_s']['p99'] * 1e3:.1f} ms | wall per decode step "
          f"{1e3 * rep['wall_s'] / eng.decode_steps:.2f} ms")
    decode_step_check(eng, gen)
    same_state_twice(eng, gen)
    return eng, path


def rwkv_timing_phase(eng, device, gen, m: int = 4):
    """Phase 7 (timing): K1's and K1g's launches of one rwkv6-3b decode
    step at M = 4 (decay_B's X float32, the rest bf16), each beside its
    bound, the plain version and the library call."""
    from repro_torch.kernels import ops
    cfg = eng.cfg
    blk = eng.packed.blocks["b0"]
    tm, cm = blk["rwkv"], blk["rwkv_cm"]

    def xs(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device, dtype=dt)

    x_d, x_f = xs(m, cfg.d_model), xs(m, cfg.d_ff)
    x_lo = xs(m, tm["decay_A"].shape[1] if tm["decay_A"] is not None
              else 64, dt=torch.float32)
    x_g = xs(5, m, tm["mix_B"].shape[0]) if tm["mix_B"] is not None else None
    seq = []
    for p in range(cfg.num_periods):
        for name in ("mix_A", "w_r", "w_k", "w_v", "w_g", "w_o",
                     "decay_A", "decay_B"):
            if tm[name] is not None:
                seq.append((x_lo if name == "decay_B" else x_d,
                            tm[name].period(p), "bitmap_spmm"))
        if tm["mix_B"] is not None:
            seq.append((x_g, tm["mix_B"].period(p), "bitmap_spmm_grouped"))
        for name, x in (("cm_k", x_d), ("cm_v", x_f), ("cm_r", x_d)):
            if cm[name] is not None:
                seq.append((x, cm[name].period(p), "bitmap_spmm"))
    seq.append((x_d, eng.lm_weight, "bitmap_spmm"))
    kernels = {"bitmap_spmm": ops.bitmap_spmm,
               "bitmap_spmm_grouped": ops.bitmap_spmm_grouped}
    libraries = {"bitmap_spmm": torch.matmul,
                 "bitmap_spmm_grouped": torch.bmm}
    return {name: time_step(f"{cfg.name} decode step, {name} only",
                            [s for s in seq if s[2] == name], kernels,
                            libraries)
            for name in kernels}


def mamba_block_check(cfg, device, gen, m: int = 4, steps: int = 8) -> dict:
    """Phase 7: one mamba block at ``cfg``'s full widths (jamba: d 4096,
    dI 8192, N 16, dt_rank 256, conv 4), seeded, pruned to 0.5 and packed
    (in_proj, x_proj at BN 96, dt_proj, out_proj through K1), stepped
    ``steps`` times at M = ``m`` through the kernels and through the
    plain versions, each carrying its own state; outputs and states held
    to each other under phase 3's rule.  Returns its path record."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import ssm
    from repro_torch.models.config import BlockCfg
    from repro_torch.models.model import _period, init_params
    from repro_torch.serve.packed import pack_model
    from repro_torch.sparse import global_l1_prune
    one = dataclasses.replace(cfg, num_layers=1, vocab_size=256,
                              pattern=(BlockCfg(mixer="mamba", ffn="none"),))
    params = global_l1_prune(init_params(gen, one, device=device), 0.5)
    packed = pack_model(params)
    mp = _period(params["blocks"]["b0"]["mamba"], 0)
    mk = _period(packed.blocks["b0"]["mamba"], 0)
    blocks = {n: bw.block for n, bw in mk.items() if bw is not None}
    dt = torch.bfloat16
    di, n = one.mamba_d_inner, one.mamba_d_state
    state = {impl: {"h": torch.zeros(m, di, n, device=device),
                    "conv": torch.zeros(m, one.mamba_conv - 1, di,
                                        device=device, dtype=dt)}
             for impl in (None, "torch")}
    reset_launches()
    for step in range(steps):
        x = torch.randn(m, 1, one.d_model, generator=gen, device=device
                        ).to(dt)
        out = {}
        for impl in (None, "torch"):
            out[impl], state[impl] = ssm.mamba_decode(
                mp, x, state[impl], one, packed=mk, impl=impl)
        sync()
        agree(out[None][:, 0], out["torch"][:, 0],
              f"mamba block step {step} output", argmax=False)
        for k in ("h", "conv"):
            agree(state[None][k].reshape(m, -1),
                  state["torch"][k].reshape(m, -1),
                  f"mamba block step {step} {k}", argmax=False)
    launches = LAUNCHES["bitmap_spmm"]
    assert launches == len(blocks) * steps, (launches, blocks)
    print(f"{cfg.name} mamba block at full width (d {one.d_model}, dI {di}, "
          f"N {n}, dt_rank {one.mamba_dt_rank}): {steps} steps at M={m}, "
          f"{len(blocks)} K1 projections per step {blocks}, "
          f"{launches} launches")
    return {"path": f"{cfg.name}, one mamba block at full width",
            "launches": launches, "launches_per_step": len(blocks),
            "decode_steps": steps, "prefill_calls": 0}


def jamba_smoke_engines(cfg, device) -> list:
    """Phase 7: jamba's hybrid wiring (mamba, attention and MoE blocks,
    the slotted state reset, dt_proj's BK = 4) at smoke widths only: the
    engine on the contiguous cache, then paged with recompute-on-preempt
    on a pool too small for every slot; the two runs serve the same
    tokens.  Returns their path records."""
    from repro_torch.serve import ServeEngine, poisson_trace
    trace = poisson_trace(8, rate=1.0, seed=1, vocab_size=cfg.vocab_size,
                          prompt_len=(4, 8), max_new=(8, 16))
    same = dict(num_slots=4, max_len=64, sparsity=0.5, seed=0, device=device)
    contig = ServeEngine(cfg, **same)
    crep = serve(contig, trace, f"{cfg.name} (smoke widths), contiguous")
    paths = [check_counts(contig, crep, f"{cfg.name} smoke, contiguous")]
    print(f"  fallbacks: {fallback_reasons(contig)}")
    paged = ServeEngine(cfg, paged=True, page_len=4, page_pool_tokens=48,
                        preempt=True, **same)
    prep = serve(paged, trace, f"{cfg.name} (smoke widths), paged + preempt"
                               f" on a 48-token pool")
    paths.append(check_counts(paged, prep, f"{cfg.name} smoke, paged + "
                                           f"preempt"))
    pe = prep["prefix_reuse"]["preempt"]
    paged.kv.audit()
    assert pe["count"] >= 1, pe
    assert prep["tokens"] == crep["tokens"], "paged + preempt parts"
    print(f"{cfg.name} at smoke widths: paged + preempt ({pe['count']} "
          f"preemptions, {pe['recomputed_tokens']} tokens recomputed) "
          f"served the contiguous run's tokens")
    return paths


def ssm_phase(rwkv_cfg, jamba_cfg, jamba_smoke, device, gen) -> dict:
    """Phase 7: the recurrent mixers.  Returns {kernel: [path records]}
    and rwkv6-3b's per-step times."""
    t0 = time.perf_counter()
    eng, path = rwkv_engine_phase(rwkv_cfg, device, gen)
    times = rwkv_timing_phase(eng, device, gen)
    profile_steps(eng)
    del eng
    torch.cuda.empty_cache()
    t0 = phase(f"phase 7a, {rwkv_cfg.name}", t0)
    block = mamba_block_check(jamba_cfg, device, gen)
    torch.cuda.empty_cache()
    smoke = jamba_smoke_engines(jamba_smoke, device)
    phase(f"phase 7b, {jamba_cfg.name}: one full-width mamba block, the "
          f"smoke engine", t0)
    return {"bitmap_spmm": [path["bitmap_spmm"], block]
            + [p["bitmap_spmm"] for p in smoke],
            "bitmap_spmm_grouped": [path["bitmap_spmm_grouped"]]
            + [p["bitmap_spmm_grouped"] for p in smoke
               if "bitmap_spmm_grouped" in p],
            "decode_attention": [p["decode_attention"] for p in smoke],
            "times": times}


# ------------------------------------------------------------ phase 8 -----

TRAIN_ARCHS = ("olmo-1b", "granite-moe-3b-a800m", "gemma3-4b", "rwkv6-3b",
               "jamba-v0.1-52b")
TRAIN_LR = 3e-4


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Operations of one train step.  ``model``: 6·N·T for the parameter
    products (N every parameter, the tied head counted once) plus the
    attention term 12·L·H·D·S·T (scores and values at full S, forward and
    backward); ``remat``: what checkpointing recomputes, each period's
    forward again (2·N·T less the embedding and head, 4·L·H·D·S·T) and
    each loss chunk's head product (2·D·V·T)."""
    t = batch * seq
    n = cfg.param_count()
    layers = sum(1 for _ in range(cfg.num_periods) for b in cfg.pattern
                 if b.mixer == "attn")
    attn = layers * cfg.num_heads * cfg.resolved_head_dim * seq * t
    head = cfg.d_model * cfg.vocab_size
    embed = head if cfg.tie_embeddings else 2 * head
    return {"model": 6 * n * t + 12 * attn,
            "remat": 2 * (n - embed) * t + 4 * attn + 2 * head * t
            if cfg.remat else 0}


# kernel-name marks of a profile's device time by kind (the first match)
KERNEL_KINDS = (("gemm", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
                ("reduction", ("reduce",)),
                ("elementwise", ("elementwise",)))


def profile_train_steps(run_step, steps: int = 2):
    """Device busy share of ``steps`` calls of ``run_step`` under
    torch.profiler, with the device time by kind of kernel.  Returns
    (idle share, busy ms per step), or None when the profiler saw no
    device time."""
    profiled = profile_device(run_step, steps)
    if profiled is None:
        return None
    kernels, wall_us = profiled
    busy_us = sum(t for _, t in kernels)
    by_kind: dict = {}
    for name, t in kernels:
        kind = next((kind for kind, marks in KERNEL_KINDS
                     if any(m in name.lower() for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    top = sorted(kernels, key=lambda kt: -kt[1])[:5]
    print(f"profiler, {steps} train steps: {wall_us / steps / 1e3:.2f} ms "
          f"per step, device busy {busy_us / steps / 1e3:.2f} ms (idle "
          f"{100 * (1 - busy_us / wall_us):.1f}%) | by kind: "
          + ", ".join(f"{k} {t / steps / 1e3:.2f} ms" for k, t in sorted(
              by_kind.items(), key=lambda kt: -kt[1]))
          + " | top: "
          + ", ".join(f"{k[:40]} {t / steps / 1e3:.2f} ms" for k, t in top))
    return 1 - busy_us / wall_us, busy_us / steps / 1e3


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def train_full_width(cfg, device, steps: int = 12, warm: int = 2,
                     profiled: int = 2, batch: int = 4, seq: int = 512,
                     long_seq: int = 2048, long_steps: int = 4,
                     smi: str = ""):
    """Phase 8a: ``cfg`` at full width trained on the card: seeded init,
    ``global_l1_prune(0.5)`` with its masks, AdamW (lr 3e-4, warmup 2,
    ``total_steps`` the steps run), remat as configured, batches of
    ``synth_batch`` (seed 0).  Steps at ``batch`` x ``seq``: ``warm``
    untimed, then timed ones (the median is theirs), then ``profiled``
    ones under torch.profiler; forward + backward alone timed at that
    batch, so the rest of the step (the mask products and AdamW, a cost
    per parameter) is read apart.  Then ``long_steps`` more at the
    published sequence length ``long_seq`` (the first untimed), the same
    reading taken.  Every loss and grad norm finite, the first loss
    within 2.5 of ln(V), every pruned element exactly 0 after every step,
    the blocks' sparsity >= 0.499.  Returns (params, masks, record)."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.steps import build_train_step, loss_and_grads
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import init_params
    from repro_torch.sparse.pruning import (global_l1_prune, sparsity_of,
                                            tree_items, tree_map)
    from repro_torch.train import optimizer as opt_lib
    t0 = time.perf_counter()
    # free what earlier phases dropped but a reference cycle still holds,
    # so that no collection during training moves the baseline below
    gc.collect()
    held = torch.cuda.memory_allocated()     # by what earlier phases keep
    gen = torch.Generator(device=device).manual_seed(0)
    params = global_l1_prune(init_params(gen, cfg, device=device), 0.5)
    masks = tree_map(lambda _, p: p != 0, params)
    # the embedding (and so the tied head) is not prunable: the blocks'
    # matrices carry the 0.5, ``sparsity_of`` over all of them less
    sparsity = sparsity_of(params["blocks"])
    assert sparsity >= 0.499, sparsity
    opt_state = opt_lib.init(params)
    step_fn = build_train_step(
        cfg, opt_lib.OptConfig(lr=TRAIN_LR, warmup_steps=2,
                               total_steps=steps + long_steps),
        prune_masks=masks)
    batches = [to_device(synth_batch(cfg, DataConfig(
        global_batch=batch, seq_len=s_, seed=0), i), device)
        for i, s_ in enumerate([seq] * steps + [long_seq] * long_steps)]
    sync()
    print(f"{cfg.name} training at full width: {cfg.param_count() / 1e9:.3f}"
          f" B parameters, init + prune {time.perf_counter() - t0:.1f}s, "
          f"sparsity of the blocks {sparsity:.4f}, remat {cfg.remat}, "
          f"{steps} steps ({warm} warm-up) at batch {batch} x seq {seq}, "
          f"then {long_steps} (1 warm-up) at batch {batch} x seq {long_seq}")
    state = {"params": params, "opt": opt_state, "i": 0}
    losses, gnorms = [], []

    def run_step():
        i = state["i"]
        state["params"], state["opt"], m = step_fn(
            state["params"], state["opt"], batches[i])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        state["i"] = i + 1

    flat_masks = dict(tree_items(masks))

    def check_masks():
        for path, leaf in tree_items(state["params"]):
            assert not bool(leaf.masked_select(~flat_masks[path]).any()), \
                path

    def timed_steps(n):
        times = []
        for _ in range(n):
            sync()
            t = time.perf_counter()
            run_step()
            sync()
            times.append(time.perf_counter() - t)
            check_masks()
        return times

    def reading(times, s_, first):
        """The timed steps at ``batch`` x ``s_`` against forward +
        backward alone on batch ``first``."""
        ms = 1e3 * median(times)
        fwd_bwd = time_ms(lambda: loss_and_grads(
            state["params"], batches[first], cfg), 1)
        flops = train_flops(cfg, batch, s_)
        return {"ms_per_step": ms, "tokens_per_s": batch * s_ / ms * 1e3,
                "model_tflops": flops["model"] / ms / 1e9,
                "mfu": flops["model"] / (ms * 1e-3) / BF16_FLOPS_PER_S,
                "hardware_tflops": (flops["model"] + flops["remat"])
                / ms / 1e9,
                "fwd_bwd_ms": fwd_bwd,
                "update_share": max(ms - fwd_bwd, 0.0) / ms,
                "timed_steps": len(times),
                "range_ms": [1e3 * min(times), 1e3 * max(times)],
                "flops": flops,
                "max_memory_gib": (torch.cuda.max_memory_allocated()
                                   - held) / 2**30}

    def show(r, s_):
        f = r["flops"]
        print(f"{cfg.name} train step at batch {batch} x seq {s_} on {smi}:"
              f" median {r['ms_per_step']:.2f} ms over {r['timed_steps']} "
              f"steps (range {r['range_ms'][0]:.2f}-{r['range_ms'][1]:.2f})"
              f" | {r['tokens_per_s']:.0f} tokens/s | model "
              f"{f['model'] / 1e12:.2f} TFLOP per step (6·N·T + attention) "
              f"= {r['model_tflops']:.1f} TFLOP/s, MFU "
              f"{100 * r['mfu']:.1f}% of {BF16_FLOPS_PER_S / 1e12:.0f} | "
              f"with the remat recompute ({f['remat'] / 1e12:.2f} TFLOP) "
              f"{r['hardware_tflops']:.1f} TFLOP/s | forward + backward "
              f"alone {r['fwd_bwd_ms']:.2f} ms, the rest (mask products, "
              f"AdamW) {100 * r['update_share']:.1f}% of the step | max "
              f"memory allocated {r['max_memory_gib']:.2f} GiB by training "
              f"({held / 2**30:.2f} GiB more held before it)")

    torch.cuda.reset_peak_memory_stats()
    times = timed_steps(steps - profiled)
    profiled_ = profile_train_steps(run_step, profiled)
    idle, busy_ms = profiled_ if profiled_ else (None, None)
    check_masks()
    rec = reading(times[warm:], seq, 0)
    torch.cuda.reset_peak_memory_stats()
    long_times = timed_steps(long_steps)
    rec["long_seq"] = {"seq": long_seq, **reading(long_times[1:], long_seq,
                                                 steps)}
    assert all(math.isfinite(v) for v in losses + gnorms), (losses, gnorms)
    assert abs(losses[0] - math.log(cfg.vocab_size)) <= 2.5, losses[0]
    sparsity = sparsity_of(state["params"]["blocks"])
    assert sparsity >= 0.499, sparsity
    overall = sparsity_of(state["params"])
    rec.update({"idle_share": idle, "busy_ms_per_step": busy_ms,
                "losses": losses, "grad_norms": gnorms,
                "sparsity_blocks": sparsity, "sparsity_all": overall})
    show(rec, seq)
    print("  idle share " + (
        "not measured" if idle is None else
        f"{100 * idle:.1f}% profiled (device busy {busy_ms:.2f} ms per "
        f"step: {100 * busy_ms / rec['ms_per_step']:.1f}% of the "
        f"unprofiled median)"))
    show(rec["long_seq"], long_seq)
    print(f"  losses {', '.join(f'{v:.4f}' for v in losses)} (ln V "
          f"{math.log(cfg.vocab_size):.4f}); grad norms "
          f"{', '.join(f'{v:.3f}' for v in gnorms)}; pruned elements 0 "
          f"after every step; sparsity of the blocks {sparsity:.4f}, of "
          f"every matrix (the unpruned embedding too) {overall:.4f}")
    return state["params"], masks, rec


def train_parity(device, batch: int = 2, seq: int = 16) -> None:
    """Phase 8b: each arch at smoke widths, float32: one train step's
    loss and gradients on the card against the CPU's from the same params
    and batch (loss within 1e-5 relative; each leaf's gradient within
    1e-4·max|CPU| + 1e-7), then a whole train step on the card, finite."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.steps import build_train_step, loss_and_grads
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import init_params
    from repro_torch.sparse.pruning import tree_items, tree_map
    from repro_torch.train import optimizer as opt_lib
    cpu = torch.device("cpu")
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             device=cpu)
        batch_np = synth_batch(cfg, DataConfig(batch, seq), 0)
        want = loss_and_grads(params, to_device(batch_np, cpu), cfg)
        on_card = tree_map(lambda _, t: t.to(device), params)
        got = loss_and_grads(on_card, to_device(batch_np, device), cfg)
        sync()
        rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        assert rel <= 1e-5, (arch, float(got[0]), float(want[0]))
        used = 0.0
        for (path, g), (_, w) in zip(tree_items(got[2]),
                                     tree_items(want[2])):
            diff = (g.cpu() - w).abs().max().item()
            limit = 1e-4 * w.abs().max().item() + 1e-7
            assert diff <= limit, (arch, path, diff, limit)
            used = max(used, diff / limit)
        state = opt_lib.init(on_card)
        on_card, state, m = build_train_step(cfg, opt_lib.OptConfig(
            lr=1e-3, warmup_steps=1, total_steps=10))(
            on_card, state, to_device(batch_np, device))
        assert all(bool(torch.isfinite(t).all())
                   for _, t in tree_items(on_card))
        print(f"  {cfg.name} train step, card against CPU (float32): loss "
              f"{float(got[0]):.6f} vs {float(want[0]):.6f} (rel "
              f"{rel:.2g}, limit 1e-5); gradients within {used:.3g} of "
              f"the limit over {len(tree_items(want[2]))} leaves; step "
              f"grad norm {float(m['grad_norm']):.4f}")


def resume_on_card(device, steps: int = 6, cut: int = 3) -> None:
    """Phase 8b: olmo smoke trained ``steps`` steps with checkpoints
    every ``cut``, its last checkpoint dropped (a crash after step
    ``cut``), then resumed: params and optimizer state equal an
    uninterrupted run's bit for bit."""
    import shutil
    from repro_torch.launch.train import train
    from repro_torch.sparse.pruning import tree_items
    from repro_torch.train import checkpoint as ckpt
    kw = dict(smoke=True, steps=steps, batch=4, seq=32, device=device,
              log_every=steps)
    whole = train("olmo-1b", **kw)
    with tempfile.TemporaryDirectory() as d:
        train("olmo-1b", ckpt_dir=d, ckpt_every=cut, **kw)
        assert sorted(ckpt.completed_steps(d)) == [cut, steps]
        shutil.rmtree(f"{d}/step_{steps}")
        res = train("olmo-1b", ckpt_dir=d, ckpt_every=cut, **kw)
    assert len(res["losses"]) == steps - cut
    assert res["losses"] == whole["losses"][cut:], (res["losses"],
                                                   whole["losses"])
    for (path, a), (_, b) in zip(tree_items(whole["params"]),
                                 tree_items(res["params"])):
        assert torch.equal(a, b), path
    print(f"  olmo-1b smoke on the card: {steps} steps cut after {cut}, "
          f"restored and resumed equal the uninterrupted run bit for bit "
          f"(losses {', '.join(f'{v:.4f}' for v in res['losses'])})")


def k2_against_scan_attention(cfg, device, gen, batch: int = 4,
                              seq: int = 512) -> None:
    """Phase 8c: K2 forward against the training path's ``scan_attention``
    at phase 8a's attention shape (B, heads, S, D causal), bf16 and
    float32, q/k/v moved to K2's (B, H, S, D); phase 5's limits, the
    zero-output check included; then both timed in bf16.  Nothing on the
    training path calls K2."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import scan_attention
    h, d = cfg.num_heads, cfg.resolved_head_dim
    pos = torch.arange(seq, device=device).expand(batch, seq)
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(batch, seq, n, d, generator=gen,
                               device=device).to(dt)
                   for n in (h, cfg.num_kv_heads, cfg.num_kv_heads))
        ref = scan_attention(q, k, v, pos)
        out = ops.flash_attention(*(t.transpose(1, 2).contiguous()
                                    for t in (q, k, v))).transpose(1, 2)
        sync()
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        rms = ref.float().square().mean(-1, keepdim=True).sqrt()
        name = (f"K2 against scan_attention {tuple(q.shape)} causal {dt}")
        err, used, zero = scaled_compare(name, out, ref, ATTN_ATOL[dt], rms)
        line = (f"  {name}: max |K2 - scan_attention| {err:.3g}, {used:.3g}"
                f" of the limit; a zero output fails at {100 * zero:.1f}% "
                f"of the non-zero elements")
        if dt == torch.bfloat16:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            t_k = time_ms(lambda: ops.flash_attention(qt, kt, vt), 20)
            t_s = time_ms(lambda: scan_attention(q, k, v, pos), 5)
            line += (f" | forward: K2 {t_k:.4f} ms, scan_attention "
                     f"{t_s:.4f} ms (eager)")
        print(line)


def serve_trained(cfg, params, device, gen, n: int = 4, budget: int = 16,
                  prompt: int = 8) -> dict:
    """Phase 8d: the params phase 8a trained (pruned by their masks)
    packed by ``pack_model`` / ``pack_lm_head`` and served: ``n``
    requests whose prompts come from the synthetic stream, budgets
    ``budget``, walked.  Every request served its whole budget, K1's
    launches per decode step as ``per_step`` says (113 for olmo-1b), no
    dense copy of a packed weight, one decode step through K1 against
    the plain step.  Returns K1's path record."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, num_slots=n, max_len=256, sparsity=0.0,
                      params=params, device=device)
    assert_no_dense_copy(eng)
    if cfg.name == "olmo-1b":
        assert per_step(eng) == {"bitmap_spmm": 113,
                                 "bitmap_spmm_grouped": 0}, per_step(eng)
    tokens = synth_batch(cfg, DataConfig(n, prompt, seed=0), 10_000)[
        "tokens"]
    trace = [{"prompt": [int(t) for t in row], "max_new_tokens": budget,
              "arrival": 0.0} for row in tokens]
    rep = serve(eng, trace, f"{cfg.name} as trained, packed")
    path = check_counts(eng, rep, f"{cfg.name} trained in phase 8a, "
                                  f"prompt walk")
    decode_step_check(eng, gen)
    return path


def training_phase(cfg, device, gen, smi: str, **sizes) -> dict:
    """Phase 8: training on the card.  Returns 8a's record and 8d's K1
    and decode-attention path records."""
    t0 = time.perf_counter()
    params, masks, rec = train_full_width(cfg, device, smi=smi, **sizes)
    del masks
    torch.cuda.empty_cache()
    t0 = phase(f"phase 8a, {cfg.name} trained at full width", t0)
    train_parity(device)
    resume_on_card(device)
    t0 = phase("phase 8b, every arch at smoke widths against the CPU; "
               "resume", t0)
    k2_against_scan_attention(cfg, device, gen,
                              batch=sizes.get("batch", 4),
                              seq=sizes.get("seq", 512))
    t0 = phase("phase 8c, K2 against scan_attention", t0)
    path = serve_trained(cfg, params, device, gen)
    del params
    torch.cuda.empty_cache()
    phase(f"phase 8d, {cfg.name} as trained, served through K1", t0)
    return {"train": rec, "bitmap_spmm": path["bitmap_spmm"],
            "decode_attention": path["decode_attention"]}


# ------------------------------------------------------------ phase 2 ----
# K1 / K1g on a sharded weight: one launch per shard (ops._sharded_spmm).
SHARDED_CASES = (("olmo qkvo", 2048, 2048, "col"),
                 ("olmo down", 8192, 2048, "row"),
                 ("olmo head", 2048, 50304, "col"))
SHARDED_EXPERT_CASES = (("granite gate_up", 1536, 512, "col"),
                        ("granite down", 512, 1536, "row"))


def sharded_against_plain(device, gen, cases, rows, groups: int = 0,
                          shards: int = 2, sparsity: float = 0.5) -> float:
    """Phase 2's sharded cases: each weight packed against its per-shard
    slice and split ``shards`` ways (``shard_bitmap``), then multiplied
    through ``ops.bitmap_spmm(_grouped)``, which launches the kernel
    once per shard (column shards concatenated, row shards' partial
    products summed), against the plain version of the unsharded
    weight.  Returns the largest absolute difference seen."""
    from repro_torch.kernels import LAUNCHES, ops
    from repro_torch.serve.packed import choose_block
    from repro_torch.sparse import (pack_bitmap, pack_bitmap_experts,
                                    per_tensor_prune)
    from repro_torch.sparse.format import (shard_bitmap,
                                           unpack_bitmap_stacked)
    name_k = "bitmap_spmm_grouped" if groups else "bitmap_spmm"
    kernel = ops.bitmap_spmm_grouped if groups else ops.bitmap_spmm
    lead = (groups,) if groups else ()
    worst = 0.0
    for name, k, n, mode in cases:
        block = (choose_block(k, n // shards) if mode == "col"
                 else choose_block(k // shards, n))
        w = per_tensor_prune(torch.randn(*lead, k, n, generator=gen,
                                         device=device), sparsity)
        bw = (pack_bitmap_experts(w[None], block=block).period(0)
              if groups else pack_bitmap(w, block=block))
        plain_w = dataclasses.replace(bw,
                                      dense_cache=unpack_bitmap_stacked(bw))
        sharded = shard_bitmap(bw, shards, mode)
        err = 0.0
        for m in rows:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(*lead, m, k, generator=gen,
                                device=device).to(dt)
                before = LAUNCHES[name_k]
                out = kernel(x, sharded, impl="cuda")
                assert LAUNCHES[name_k] - before == shards, (name, m, dt)
                ref = kernel(x, plain_w, impl="torch")
                sync()
                err = max(err, _compare(f"{name} {mode}/{shards} M={m}",
                                        out, ref, k, dt))
        worst = max(worst, err)
        print(f"  sharded {name} {'G=%d ' % groups if groups else ''}"
              f"K={k} N={n} {mode} x{shards}, block {block}: one launch "
              f"per shard, max |kernel - plain of the unsharded weight| "
              f"{err:.3g} over M={list(rows)}, f32 and bf16")
        del bw, plain_w, sharded, w
    return worst


# ------------------------------------------------------------ phase 9 ----
# Sharded serving: a world of 2 ranks, each its own process, serving
# full-width olmo-1b through the gather-then-compute step.
P9_RUNS = ({"label": "a: model_parallel 2, contiguous", "mp": 2,
            "paged": False, "checksum": True},
           {"label": "b: model_parallel 1, paged, kv_shards 2", "mp": 1,
            "paged": True, "checksum": False})
P9 = dict(slots=4, max_len=64, sparsity=0.5, page_len=16, seed=9)
RANK_COMMAND = [sys.executable, str(ROOT / "chip_smoke.py"), "--phase9-rank"]


def _p9_engine(cfg, params, device, run):
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, params=params, device=device,
                       num_slots=P9["slots"], max_len=P9["max_len"],
                       sparsity=P9["sparsity"], seed=0,
                       model_parallel=run["mp"], paged=run["paged"],
                       page_len=P9["page_len"])


def _resident(eng) -> int:
    """Packed bytes this process holds: the stack's leaves and the head
    (a rank's parts only)."""
    head = eng.lm_weight.resident_bytes if eng.lm_weight is not None else 0
    return sum(bw.resident_bytes for _, bw in eng.packed.leaves()) + head


def phase9_rank(spec_path: str, out_dir: str) -> int:
    """One rank of phase 9 (``chip_smoke.py --phase9-rank SPEC OUT``,
    started by ``sharded_phase`` with RANK / WORLD_SIZE / LOCAL_RANK /
    MASTER_ADDR / MASTER_PORT set): joins the world with the spec's
    backend, draws olmo-1b's params from the spec's seed, serves the
    trace in each run and writes what it saw to OUT/rank<r>.json."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import init_world
    from repro_torch.launch.steps import _gather_packed, _gather_weight
    from repro_torch.models.model import init_params
    from repro_torch.serve.faults import _checksum
    spec = json.load(open(spec_path))
    device = init_world(spec["backend"], "cuda")
    cfg = get_config(spec["arch"])
    gen = torch.Generator(device=device).manual_seed(P9["seed"])
    params = init_params(gen, cfg, device=device)
    out = {"rank": dist.get_rank(), "device": str(device), "runs": []}
    for run in P9_RUNS:
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        eng = _p9_engine(cfg, params, device, run)
        torch.cuda.synchronize(device)
        rec = {"held_bytes": torch.cuda.memory_allocated(device) - before,
               "resident": _resident(eng), "mesh": eng.mesh.shape,
               "shards": eng.weight_stream_report()["shards"],
               "kv_shards": eng.kv.shards if eng.page_len else 1,
               "dense_resident": eng.resident_dense_bytes(),
               "dense_gather": sorted("/".join(p)
                                      for p in eng.dense_gather)}
        if run["checksum"]:
            full, _ = _gather_packed(eng.packed.blocks, eng.mesh)
            rec["stack_crc"] = [_checksum(bw) for bw in (
                w for bd in full.values() for t in bd.values()
                for w in t.values() if w is not None)]
            head, _ = _gather_weight(eng.lm_weight, eng.mesh)
            rec["head_crc"] = _checksum(head)
            del full, head
        eng.warmup()
        torch.cuda.synchronize(device)
        eng._step_fn.stats.reset()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        reqs = [eng.submit(**r) for r in spec["trace"]]
        rep = eng.run()
        rec.update(tokens=[list(r.tokens) for r in reqs],
                   launches=dict(LAUNCHES), decode_steps=eng.decode_steps,
                   wall_s=rep["wall_s"], gather=eng._step_fn.stats.report(),
                   peak=torch.cuda.max_memory_allocated(device))
        out["runs"].append(rec)
        del eng, rep
        gc.collect()
        torch.cuda.empty_cache()
    with open(pathlib.Path(out_dir) / f"rank{out['rank']}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _spawn_world(backend: str, spec: dict, world: int = 2,
                 timeout: int = 600, command=None, label: str = "phase 9"
                 ) -> list:
    """Start ``world`` ranks of ``command`` (phase 9's by default) with
    ``backend`` and wait for them; a rank that fails fails the phase.
    Returns each rank's record."""
    command = RANK_COMMAND if command is None else command
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = pathlib.Path(tmp) / "spec.json"
        spec_path.write_text(json.dumps({**spec, "backend": backend}))
        env = {**os.environ, "WORLD_SIZE": str(world),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [*command, str(spec_path), tmp],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"{label} rank {r} ({backend}) "
                                     f"exited {p.returncode}:\n"
                                     f"{log[-4000:]}")
        return [json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
                for r in range(world)]


def sharded_phase(cfg, device, smi: str, requests: int = 4,
                  budget: int = 8) -> list:
    """Phase 9: sharded serving over ``torch.distributed``.  First the
    one-rank engine serves the trace in each run's layout here (the
    tokens to match, the packed bytes one process holds), then a world of
    2 ranks serves it: gloo, both ranks on this card (NCCL cannot put
    two ranks on one card), and, on a host with 2 cards or more, NCCL
    with a card per rank.  (a) model_parallel 2, contiguous: the packed
    stack and the vocabulary-split head sharded, each rank holding its
    half; (b) model_parallel 1, paged with kv_shards 2: the weights
    whole, the page pools sharded over the data axis.  Checks: tokens
    equal to the one-rank run's exactly (the gathered weights are
    byte-equal, the base step unchanged); in (a) the gathered stack's
    checksums equal to the one-rank pack's and the head's to the
    unsharded vocabulary-split pack's; 113 K1 launches per decode step
    on each rank; each rank's resident packed bytes about half the
    one-rank figure, by the manifest and by ``memory_allocated``.
    Returns K1's path records (launches summed over the ranks)."""
    from repro_torch.models.model import init_params
    from repro_torch.serve import poisson_trace
    from repro_torch.serve.engine import pack_lm_head
    from repro_torch.serve.faults import _checksum
    from repro_torch.sparse.format import unshard_bitmap
    trace = poisson_trace(requests, rate=0.5, seed=P9["seed"],
                          vocab_size=cfg.vocab_size, prompt_len=(4, 12),
                          max_new=(budget, budget))
    per_step = 7 * cfg.num_periods + 1
    gen = torch.Generator(device=device).manual_seed(P9["seed"])
    params = init_params(gen, cfg, device=device)
    single = []
    for run in P9_RUNS:
        sync()
        before = torch.cuda.memory_allocated()
        eng = _p9_engine(cfg, params, device, dict(run, mp=1))
        sync()
        rec = {"held_bytes": torch.cuda.memory_allocated() - before,
               "resident": _resident(eng),
               "dense_resident": eng.resident_dense_bytes()}
        if run["checksum"]:
            rec["stack_crc"] = [_checksum(bw)
                                for _, bw in eng.packed.leaves()]
            rec["head_crc"] = _checksum(unshard_bitmap(pack_lm_head(
                eng.params, cfg, P9["sparsity"], shards=2)))
        rep = serve(eng, trace, f"phase 9 one rank ({run['label']})")
        rec.update(tokens=rep["tokens"], decode_steps=eng.decode_steps,
                   wall_s=rep["wall_s"])
        single.append(rec)
        del eng, rep
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2
                           else [])
    print(f"phase 9 on {smi}: {torch.cuda.device_count()} card(s); "
          f"backends {backends} (gloo puts both ranks on cuda:0 and "
          f"gathers through host memory"
          + ("" if len(backends) > 1 else "; NCCL needs a card per rank, "
             "so it does not run on this host") + ")")
    paths = []
    for backend in backends:
        t0 = time.perf_counter()
        ranks = _spawn_world(backend, {"arch": cfg.name, "trace": trace})
        print(f"phase 9 {backend}: 2 ranks in "
              f"{time.perf_counter() - t0:.1f}s (start, init, prune, pack, "
              f"serve both runs)")
        for i, run in enumerate(P9_RUNS):
            one = single[i]
            for res in ranks:
                r = res["runs"][i]
                tag = f"phase 9 {backend} rank {res['rank']} ({run['label']})"
                assert r["tokens"] == one["tokens"], (tag, r["tokens"],
                                                      one["tokens"])
                assert r["launches"]["bitmap_spmm"] == (
                    per_step * r["decode_steps"]), (tag, r["launches"])
                assert r["launches"]["bitmap_spmm_grouped"] == 0, tag
                if run["mp"] > 1:
                    assert r["shards"] == 2 and r["mesh"] == {
                        "data": 1, "model": 2}, tag
                    assert r["stack_crc"] == one["stack_crc"], tag
                    assert r["head_crc"] == one["head_crc"], tag
                    share = r["resident"] / one["resident"]
                    assert 0.45 <= share <= 0.55, (tag, share)
                    saved = one["held_bytes"] - r["held_bytes"]
                    assert saved >= 0.4 * one["resident"], (tag, saved)
                    # the dense params by param_specs: the block matrices
                    # halve (the embedding and norms stay replicated)
                    dshare = r["dense_resident"] / one["dense_resident"]
                    assert 0.5 < dshare <= 0.6, (tag, dshare)
                    assert r["dense_gather"] == [], tag
                    assert r["gather"][
                        "dense_bytes_received_per_call"] == 0, tag
                else:
                    assert r["kv_shards"] == 2 and r["mesh"] == {
                        "data": 2, "model": 1}, tag
                g = r["gather"]
                print(f"  {tag} on {res['device']}: tokens equal to one "
                      f"rank's ({sum(map(len, r['tokens']))}); "
                      f"{r['launches']['bitmap_spmm'] // r['decode_steps']}"
                      f" K1 launches per decode step x {r['decode_steps']};"
                      f" step wall {1e3 * r['wall_s'] / r['decode_steps']:.1f}"
                      f" ms (one rank "
                      f"{1e3 * one['wall_s'] / one['decode_steps']:.1f}"
                      f" ms); gather {g['ms_per_call']:.1f} ms and "
                      f"{g['bytes_received_per_call'] / 1e6:.1f} MB "
                      f"received per decode step (dense params "
                      f"{g['dense_bytes_received_per_call'] / 1e6:.3f} MB"
                      f"); resident packed "
                      f"{r['resident'] / 1e9:.3f} GB (one rank "
                      f"{one['resident'] / 1e9:.3f}), resident dense "
                      f"{r['dense_resident'] / 2**30:.2f} GiB (one rank "
                      f"{one['dense_resident'] / 2**30:.2f}), held by the "
                      f"engine "
                      f"{r['held_bytes'] / 2**30:.2f} GiB (one rank "
                      f"{one['held_bytes'] / 2**30:.2f}); peak "
                      f"{r['peak'] / 2**30:.2f} GiB; backend {backend}")
            if run["checksum"]:
                print(f"  gathered stack and head byte-equal to the "
                      f"unsharded packs ({len(one['stack_crc'])} leaves "
                      f"+ head, CRC32)")
            paths.append({"path": f"phase 9, {cfg.name} sharded over 2 "
                                  f"ranks, {backend}, {run['label']}",
                          "launches": sum(res["runs"][i]["launches"][
                              "bitmap_spmm"] for res in ranks),
                          "launches_per_step": per_step, "ranks": 2,
                          "decode_steps": ranks[0]["runs"][i][
                              "decode_steps"]})
    return paths



# ----------------------------------------------------------- phase 10 ----
# Sharded training: a world of 2 ranks, each its own process, training
# full-width olmo-1b through the gather-then-compute step.
P10_RUNS = ({"label": "a: data 1 x model 2", "mp": 2, "exact": True},
            {"label": "b: data 2 x model 1, ZeRO-1 moments", "mp": 1,
             "exact": False})
P10 = dict(batch=4, seq=512, steps=2, sparsity=0.5, seed=0,
           compress_elems=16 * 2**20)
RANK10_COMMAND = [sys.executable, str(ROOT / "chip_smoke.py"),
                  "--phase10-rank"]


def _host(tree):
    from repro_torch.sparse.pruning import tree_map
    return tree_map(lambda _, t: t.to("cpu", copy=True), tree)


def _to(tree, device):
    from repro_torch.sparse.pruning import tree_map
    return tree_map(lambda _, t: t.to(device), tree)


def _p10_opt(steps: int):
    from repro_torch.train import optimizer as opt_lib
    return opt_lib.OptConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=steps)


def _p10_compression(mesh, device) -> dict:
    """``compressed_psum_grads`` over the data axis on a seeded 16 M
    float32 gradient (rank r's gradient is the weight times r + 1),
    against the formula on the CPU."""
    from repro_torch.train.compression import (compressed_psum_grads,
                                               init_error_fb, quantize_int8)
    n = P10["compress_elems"]
    gen = torch.Generator(device=device).manual_seed(P10["seed"] + 10)
    w = torch.randn(n, generator=gen, device=device)
    rows = torch.arange(1, mesh.data + 1, dtype=torch.float32,
                        device=device)[:, None]
    fn = compressed_psum_grads(lambda p, b: {"w": p["w"] * b[0]}, mesh)
    err = init_error_fb({"w": w}, mesh.data)
    fn({"w": w}, rows, err)                          # warm
    sync()
    t = time.perf_counter()
    grads, resid = fn({"w": w}, rows, err)
    sync()
    ms = 1e3 * (time.perf_counter() - t)
    # the CPU formula: sum_q x mean_scale / n over every rank's gradient
    wc = w.cpu()
    qs = [quantize_int8(wc * float(r + 1)) for r in range(mesh.data)]
    mean = sum(s for _, s in qs) / mesh.data
    want = sum(q.to(torch.int32) for q, _ in qs).float() * mean / mesh.data
    quantum = float(mean / mesh.data)
    err_max = float((grads["w"].cpu() - want).abs().max())
    assert err_max <= quantum, (err_max, quantum)
    assert resid["w"].shape == (1, n)
    return {"ms": ms, "max_abs_err": err_max, "quantum": quantum,
            "int32_wire_bytes": 4 * n, "float32_wire_bytes": 4 * n,
            "int8_payload_bytes": n, "elems": n}


def phase10_rank(spec_path: str, out_dir: str) -> int:
    """One rank of phase 10 (``chip_smoke.py --phase10-rank SPEC OUT``,
    started by ``sharded_training_phase``): joins the world, draws and
    prunes olmo-1b's params from phase 8a's seed, (rank 0) trains the
    one-rank baseline, then trains each run sharded, checks it against
    the baseline and writes what it saw to OUT/rank<r>.json."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_world, make_elastic_mesh
    from repro_torch.launch.steps import (build_train_step,
                                          build_train_step_spmd)
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import init_params
    from repro_torch.sparse.pruning import (global_l1_prune, tree_items,
                                            tree_map)
    from repro_torch.train import optimizer as opt_lib
    spec = json.load(open(spec_path))
    device = init_world(spec["backend"], "cuda")
    rank = dist.get_rank()
    cfg = get_config(spec["arch"])
    steps = P10["steps"]
    gen = torch.Generator(device=device).manual_seed(P10["seed"])
    params = global_l1_prune(init_params(gen, cfg, device=device),
                             P10["sparsity"])
    masks = tree_map(lambda _, p: p != 0, params)
    init_host, masks_host = _host(params), _host(masks)
    batches = [to_device(synth_batch(cfg, DataConfig(
        global_batch=P10["batch"], seq_len=P10["seq"], seed=0), i), device)
        for i in range(steps)]
    out = {"rank": rank, "device": str(device), "runs": []}
    base_losses, base = None, None
    if rank == 0:
        step = build_train_step(cfg, _p10_opt(steps), prune_masks=masks)
        opt = opt_lib.init(params)
        base_losses, base_ms = [], []
        for b in batches:
            sync()
            t = time.perf_counter()
            params, opt, m = step(params, opt, b)
            base_losses.append(float(m["loss"]))
            sync()
            base_ms.append(1e3 * (time.perf_counter() - t))
        # the first step warms the allocator and the libraries
        out["one_rank_ms"] = base_ms
        base = _host(params)
        del opt, step
    del params, masks
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    for run in P10_RUNS:
        mesh = make_elastic_mesh(run["mp"], "cuda")
        pspecs = shd.param_specs(cfg, mesh)
        ospecs = shd.opt_specs(cfg, mesh)
        parts = _to(shd.shard_tree(init_host, pspecs, mesh), device)
        mparts = _to(shd.shard_tree(masks_host, pspecs, mesh), device)
        # zero moments of this rank's ZeRO-1 part shapes (views for the
        # shapes: no copy)
        flat_os = dict(tree_items(ospecs["m"]))
        opt = _to(opt_lib.init(tree_map(
            lambda p, t: shd.shard_leaf(t, flat_os[p], mesh), init_host)),
            device)
        step = build_train_step_spmd(cfg, _p10_opt(steps), mesh,
                                     prune_masks=mparts)
        sync()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        losses, times = [], []
        for b in batches:
            sync()
            t = time.perf_counter()
            parts, opt, m = step(parts, opt, b)
            sync()
            times.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
        flat_m = dict(tree_items(mparts))
        pruned_zero = all(not bool(t[~flat_m[p]].any())
                          for p, t in tree_items(parts))
        rec = {"label": run["label"], "mesh": mesh.shape, "losses": losses,
               "step_ms": [1e3 * x for x in times],
               "gather": step.stats["gather"].report(),
               "all_reduce": step.stats["all_reduce"].report(),
               "peak": torch.cuda.max_memory_allocated(device),
               "held": held, "pruned_zero": pruned_zero,
               "param_resident": shd.resident_bytes(parts),
               "param_whole": shd.whole_bytes(parts, pspecs, mesh),
               "moment_resident": shd.resident_bytes(opt["m"])
               + shd.resident_bytes(opt["v"]),
               "moment_whole": 2 * shd.whole_bytes(
                   parts, pspecs, mesh)}
        # the whole params, leaf by leaf, against the one-rank run's
        flat_ps = dict(tree_items(pspecs))
        flat_base = dict(tree_items(base)) if rank == 0 else {}
        equal, worst = True, 0.0
        for p, t in tree_items(parts):
            whole = shd.gather_leaf(t, flat_ps[p], mesh)
            if rank == 0:
                want = flat_base[p].to(device)
                equal = equal and torch.equal(whole, want)
                worst = max(worst, float((whole - want).abs().max()))
            del whole
        if rank == 0:
            rec.update(params_equal=equal, params_max_abs_diff=worst,
                       one_rank_losses=base_losses)
        out["runs"].append(rec)
        del parts, mparts, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    mesh = make_elastic_mesh(1, "cuda")
    out["compression"] = _p10_compression(mesh, device)
    with open(pathlib.Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def sharded_training_phase(cfg, smi: str) -> None:
    """Phase 10: sharded training over ``torch.distributed`` (the module
    docstring).  Each rank is a process of its own, which builds and
    checks its runs; a rank that fails fails the phase."""
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2
                           else [])
    print(f"phase 10 on {smi}: {torch.cuda.device_count()} card(s); "
          f"backends {backends} (gloo puts both ranks on cuda:0 and moves "
          f"every collective through host memory"
          + ("" if len(backends) > 1 else "; NCCL needs a card per rank, "
             "so it does not run on this host") + ")")
    for backend in backends:
        t0 = time.perf_counter()
        ranks = _spawn_world(backend, {"arch": cfg.name}, timeout=900,
                             command=RANK10_COMMAND, label="phase 10")
        print(f"phase 10 {backend}: 2 ranks in "
              f"{time.perf_counter() - t0:.1f}s (start, init, prune, the "
              f"one-rank baseline, both runs)")
        base = ranks[0]
        for i, run in enumerate(P10_RUNS):
            r0 = base["runs"][i]
            tag = f"phase 10 {backend} ({run['label']})"
            want = r0["one_rank_losses"]
            if run["exact"]:
                assert r0["losses"] == want, (tag, r0["losses"], want)
                assert r0["params_equal"], (tag, r0["params_max_abs_diff"])
            else:
                assert max(abs(a - b) for a, b in
                           zip(r0["losses"], want)) < 1e-3, (tag, want)
                assert r0["params_max_abs_diff"] < 5e-3, (
                    tag, r0["params_max_abs_diff"])
            for res in ranks:
                r = res["runs"][i]
                rtag = f"{tag} rank {res['rank']}"
                assert r["losses"] == r0["losses"], rtag
                assert all(math.isfinite(v) for v in r["losses"]), rtag
                assert r["pruned_zero"], rtag
                pshare = r["param_resident"] / r["param_whole"]
                mshare = r["moment_resident"] / r["moment_whole"]
                if run["mp"] > 1:
                    assert 0.5 <= pshare <= 0.6, (rtag, pshare)
                else:
                    assert 0.5 <= mshare <= 0.6, (rtag, mshare)
                g, a = r["gather"], r["all_reduce"]
                received = (g["bytes_received_per_call"]
                            + a["bytes_received_per_call"])
                print(f"  {rtag} on {res['device']}: step "
                      f"{median(r['step_ms']):.1f} ms (steps "
                      + ", ".join(f"{x:.1f}" for x in r["step_ms"])
                      + "; one rank's steps, the first cold: "
                      + ", ".join(f"{x:.1f}" for x in base["one_rank_ms"])
                      + f"); gather {g['ms_per_call']:.1f} ms and "
                      f"all-reduce {a['ms_per_call']:.1f} ms per step; "
                      f"received {received / 1e9:.3f} GB per step (gather "
                      f"{g['bytes_received_per_call'] / 1e9:.3f}, ring "
                      f"all-reduce {a['bytes_received_per_call'] / 1e9:.3f})"
                      f"; resident params {r['param_resident'] / 2**30:.2f}"
                      f" of {r['param_whole'] / 2**30:.2f} GiB ({pshare:.3f})"
                      f", moments {r['moment_resident'] / 2**30:.2f} of "
                      f"{r['moment_whole'] / 2**30:.2f} GiB ({mshare:.3f});"
                      f" peak {r['peak'] / 2**30:.2f} GiB ("
                      f"{r['held'] / 2**30:.2f} held before the steps); "
                      f"backend {backend}")
            print(f"  {tag}: losses {r0['losses']} against one rank's "
                  f"{want}; params "
                  + ("bit-equal" if r0["params_equal"] else
                     f"within {r0['params_max_abs_diff']:.3g}")
                  + "; pruned elements 0 on every rank")
        c = base["compression"]
        print(f"  phase 10 {backend} compressed_psum_grads over 2 ranks, "
              f"{c['elems']} float32 elements: {c['ms']:.1f} ms, max |card"
              f" - CPU formula| {c['max_abs_err']:.3g} (one quantum "
              f"{c['quantum']:.3g}); int32 wire {c['int32_wire_bytes'] / 1e6:.1f}"
              f" MB per rank, as float32's {c['float32_wire_bytes'] / 1e6:.1f}"
              f" MB (the int8 payload itself {c['int8_payload_bytes'] / 1e6:.1f}"
              f" MB)")

# ------------------------------------------------ phase 11: musicgen ----


def replay_on_card(eng, steps=(0, 1, 17, 10**6), reps: int = 50) -> float:
    """The frames draws on the card against the same replay on the CPU:
    bits exact, normals within 4 float32 ulps (the tests hold the CPU
    replay, keys included, to ``jax.random``).  Returns the wall ms per
    draw of one decode step's (num_slots, 1, d_model) embeddings,
    ``fold_in`` included, over ``reps`` draws and one sync: host time,
    since the draw's ~180 launches each do a few microseconds' work."""
    from repro_torch import prng
    d, b, dev = eng.cfg.d_model, eng.num_slots, eng.device
    worst = 0
    for step in steps:
        key = prng.fold_in(eng._embed_key, step)
        bits = prng.random_bits(key, b * d, dev)
        assert bits.device.type == dev.type
        assert torch.equal(bits.cpu(), prng.random_bits(key, b * d))
        got = prng.normal(key, (b, 1, d), dev).cpu()
        want = prng.normal(key, (b, 1, d))

        def ordinal(t):
            i = t.view(torch.int32).long()
            return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

        ulps = int((ordinal(got) - ordinal(want)).abs().max())
        assert ulps <= 4, (step, ulps)
        worst = max(worst, ulps)
    sync()
    t0 = time.perf_counter()
    for step in range(reps):
        prng.normal(prng.fold_in(eng._embed_key, step), (b, 1, d), dev)
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    print(f"frames replay on the card: {b * d} bits per step equal the "
          f"CPU's at steps {list(steps)}; normals within {worst} ulps "
          f"(limit 4) | one step's draw {ms:.3f} ms wall (host-bound, "
          f"mean of {reps})")
    return ms


def musicgen_phase(cfg, device, gen, trace_len: int = 8):
    """Phase 11: musicgen-medium (the frames frontend) served through K1
    at full width, contiguous then paged; returns the path records and
    one decode step's K1 timing tuple."""
    from repro_torch.serve import ServeEngine, poisson_trace
    from repro_torch.serve.engine import kv_fallbacks, prefill_fallback
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, num_slots=4, max_len=256, sparsity=0.5, seed=0,
                      device=device)
    ws = eng.weight_stream_report()
    print(f"engine {cfg.name} ({cfg.param_count() / 1e9:.3f} B params): "
          f"init {eng.init_s:.2f}s, prune + pack {eng.pack_s:.2f}s "
          f"(constructor {time.perf_counter() - t0:.2f}s) | weight sparsity "
          f"{eng.weight_sparsity:.4f} | head compression "
          f"{eng.head_compression:.3f}x | modeled weight bytes per step "
          f"{ws['sparse_bytes_per_step'] / 1e9:.3f} GB packed vs "
          f"{ws['dense_bytes_per_step'] / 1e9:.3f} GB dense | executed "
          f"{executed_bytes(eng) / 1e9:.3f} GB | max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert_no_dense_copy(eng)
    want = per_step(eng)
    if cfg.name == "musicgen-medium":
        assert want == {"bitmap_spmm": 6 * 48 + 1,
                        "bitmap_spmm_grouped": 0}, want
    draw_ms = replay_on_card(eng)
    trace = poisson_trace(trace_len, rate=0.5, seed=0,
                          vocab_size=cfg.vocab_size, prompt_len=(1, 4),
                          max_new=(8, 24))
    margins = record_margins(eng)
    rep = serve(eng, trace, f"{cfg.name} packed engine (frames), "
                            f"contiguous")
    paths = [check_counts(eng, rep, f"{cfg.name}, frames, contiguous")]
    step_ms = 1e3 * rep["wall_s"] / eng.decode_steps
    print(f"{cfg.name}: {rep['tok_per_s']:.2f} tok/s | latency p50 "
          f"{rep['latency_s']['p50'] * 1e3:.1f} ms p99 "
          f"{rep['latency_s']['p99'] * 1e3:.1f} ms | wall per decode step "
          f"{step_ms:.2f} ms, of which the frames draw {draw_ms:.3f} ms "
          f"({100 * draw_ms / step_ms:.1f} %)")
    decode_step_check(eng, gen)

    t0 = time.perf_counter()
    paged = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                        head_sparsity=eng.head_sparsity, paged=True,
                        page_len=16, prefix_reuse=True, preempt=True,
                        prefill_chunk=16, device=device)
    fb = paged.report()["fallbacks"]
    reasons = kv_fallbacks(cfg, True, True, True)
    assert "paging" not in fb and paged.page_len == 16, fb
    assert fb["prefix_reuse"] == reasons["prefix_reuse"], fb
    assert fb["preempt"] == reasons["preempt"], fb
    assert fb["prefill"] == prefill_fallback(cfg), fb
    assert all("frames" in fb[k] for k in ("prefix_reuse", "preempt",
                                          "prefill")), fb
    for k in ("prefill", "prefix_reuse", "preempt"):
        print(f"  fallback {k}: {fb[k]}")
    assert_no_dense_copy(paged)
    prep = serve(paged, trace, f"{cfg.name} paged engine (page_len 16; "
                               f"reuse, preempt and chunked prefill asked)")
    paths.append(check_counts(paged, prep, f"{cfg.name}, frames, paged"))
    assert prep["paging"]["pages_in_use"] == 0
    paged.kv.audit()
    same_tokens_or_near_tie(prep, rep, margins, cfg.d_model,
                            f"{cfg.name} paged vs contiguous")
    decode_step_check(paged, gen)
    print(f"paged: tok/s {prep['tok_per_s']:.2f} vs {rep['tok_per_s']:.2f} "
          f"contiguous | wall per decode step "
          f"{1e3 * prep['wall_s'] / paged.decode_steps:.2f} ms vs "
          f"{step_ms:.2f} ms | pages peak "
          f"{prep['paging']['pages_peak']} of "
          f"{prep['paging']['pages_total']} [run "
          f"{time.perf_counter() - t0:.1f}s]")
    del paged
    torch.cuda.empty_cache()
    busy = profile_steps(eng)
    times = musicgen_timing(eng, device, gen)
    print(f"{cfg.name} decode step: K1 {times[0]:.3f} ms of "
          f"{step_ms:.2f} ms wall (byte bound {times[2]:.3f} ms); device busy "
          f"{'not measured' if busy is None else f'{busy:.2f} ms'}")
    del eng
    torch.cuda.empty_cache()
    return paths, times


def musicgen_timing(eng, device, gen, m: int = 4):
    """Phase 11 (timing): one decode step's 289 K1 launches at M = 4
    (bf16 X), beside the byte bound, the plain version and the dense
    library call."""
    from repro_torch.kernels import ops
    cfg = eng.cfg
    blk = eng.packed.blocks["b0"]
    attn, mlp = blk["attn"], blk["mlp"]
    x_d = torch.randn(m, cfg.d_model, generator=gen, device=device,
                      dtype=torch.bfloat16)
    x_f = torch.randn(m, cfg.d_ff, generator=gen, device=device,
                      dtype=torch.bfloat16)
    seq = []
    for p in range(cfg.num_periods):
        seq += [(x_d, attn[n].period(p)) for n in ("wq", "wk", "wv", "wo")]
        seq += [(x_d, mlp["w_up"].period(p)), (x_f, mlp["w_down"].period(p))]
    seq.append((x_d, eng.lm_weight))
    return time_step(f"one {cfg.name} decode step",
                     [(x, w, "bitmap_spmm") for x, w in seq],
                     {"bitmap_spmm": ops.bitmap_spmm},
                     {"bitmap_spmm": torch.matmul})


# ------------------------------------------------ phase 12: examples ----

EXAMPLES = ("quickstart", "serve_batched", "train_sparse_lm")


def examples_phase(device) -> list:
    """Phase 12: the port's device examples (``examples/torch``) through
    their ``main`` with default arguments (the card; elsewhere
    ``--device`` names the device), each printing ``OK``, its launches
    counted.  Returns their path records."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.kernels import LAUNCHES, reset_launches
    argv = [] if device.type == "cuda" else ["--device", str(device)]
    paths = []
    for name in EXAMPLES:
        t0 = time.perf_counter()
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        sync()
        reset_launches()
        with contextlib.redirect_stdout(out):
            mod.main(argv)
        sync()
        launches = dict(LAUNCHES)
        reset_launches()
        text = out.getvalue()
        lines = text.rstrip().splitlines()
        print("\n".join(f"  | {ln}" for ln in lines[-4:]))
        assert lines and lines[-1] == "OK", (name, lines[-3:])
        print(f"example {name}: OK in {time.perf_counter() - t0:.1f}s, "
              f"launches {launches}")
        for kernel, n in launches.items():
            if n:
                paths.append((kernel, {"path": f"examples/torch/{name}.py",
                                       "launches": n}))
    assert any(k == "bitmap_spmm" for k, _ in paths), paths
    return paths


# ------------------------------------- phase 13: sampled tokens, counts ----

# (temperature, top-k) of the sampled requests, in turn; None: greedy
SAMPLED = ((0.8, 0), None, (1.0, 40), None)


def sampled_trace(vocab: int, n: int = 8) -> list:
    """Phase 13's trace: a seeded Poisson trace with every other
    request sampled (``SAMPLED``), each with a seed of its own."""
    from repro_torch.serve import poisson_trace
    trace = poisson_trace(n, rate=0.5, seed=0, vocab_size=vocab,
                          prompt_len=(1, 4), max_new=(8, 24))
    for i, spec in enumerate(trace):
        knob = SAMPLED[i % len(SAMPLED)]
        if knob is not None:
            spec.update(temperature=knob[0], top_k=knob[1], seed=900 + i)
    return trace


def sampler_check(eng) -> dict:
    """One decode step of ``eng`` with four set slots (T, top-k): (0.8,
    0), (1.0, 40), (0.9, 3), greedy.  The keys folded with the slots'
    positions on the card, their Gumbel bits and values against the CPU
    replay; every token against argmax(logits / T + gumbel) over the
    slot's top-k, computed on the CPU from the step's logits."""
    from repro_torch import prng
    slots = ((0.8, 0), (1.0, 40), (0.9, 3), (0.0, 0))
    eng._temp[:] = [t for t, _ in slots]
    eng._topk[:] = [k for _, k in slots]
    eng._keys[:] = [prng.prng_key(700 + i) for i in range(4)]
    eng._pos[:] = [5, 17, 30, 100]
    eng._tok[:] = [11, 12, 13, 14]
    eng._use_sampling = eng._use_topk_vec = True
    fn, args, kw = eng.traffic.step_call("decode", meta=False)
    nxt, logits, _ = fn(*args, **kw)
    sync()
    vocab = logits.shape[-1]
    keys = prng.fold_in_rows(kw["sample_keys"], args[3])
    cpu_keys = prng.fold_in_rows(kw["sample_keys"].cpu(), args[3].cpu())
    assert torch.equal(keys.cpu(), cpu_keys)
    bits = prng.random_bits_rows(keys, vocab)
    assert torch.equal(bits.cpu(), prng.random_bits_rows(cpu_keys, vocab))
    g_card = prng.gumbel_rows(keys, vocab).cpu()
    g = prng.gumbel_rows(cpu_keys, vocab)
    g_err = float((g_card - g).abs().max())
    assert g_err <= 1e-6, g_err
    lg = logits.float().cpu()
    want = []
    for i, (t, k) in enumerate(slots):
        if t == 0:
            want.append(int(lg[i].argmax()))
            continue
        scaled = lg[i] / t
        if k:
            kth = scaled.sort(descending=True).values[k - 1]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        want.append(int((scaled + g[i]).argmax()))
    got = nxt.cpu().tolist()
    assert got == want, (got, want)
    print(f"sampler on the card: 4 slots (T, top-k) {list(slots)}: folded "
          f"keys and {vocab} Gumbel bits per slot equal the CPU replay's, "
          f"Gumbel values within {g_err:.3g} (limit 1e-6); tokens {got} "
          f"equal argmax(logits / T + gumbel) over each slot's top-k")
    return {"gumbel_max_abs_err": g_err, "tokens": got}


def crosscheck_on_card(eng) -> dict:
    """Phase 13b: the traffic ledger's cross-check with the card's
    dispatch, and one decode step executed under the counter against
    its meta count, op for op."""
    t0 = time.perf_counter()
    cc = eng.traffic.crosscheck()
    cc_s = time.perf_counter() - t0
    assert cc["dispatch"] == "cuda", cc["dispatch"]
    d = cc["decode"]
    lo, hi = d["tolerance"]
    assert d["ratio"] >= lo, d
    meta = eng.traffic.count("decode")
    sync()
    run = eng.traffic.count("decode", meta=False)
    sync()
    assert len(meta.ops) == len(run.ops)
    for i, (a, b) in enumerate(zip(meta.ops, run.ops)):
        assert a == b, (i, a, b)
    assert meta.result() == run.result()
    kernels = sum(1 for n, _, _ in run.ops if n == "bitmap_spmm")
    assert kernels == per_step(eng)["bitmap_spmm"], kernels
    by_op = {}
    for name, _, nbytes in run.ops:
        calls, total = by_op.get(name, (0, 0))
        by_op[name] = (calls + 1, total + nbytes)
    top = sorted(by_op.items(), key=lambda kv: -kv[1][1])[:8]
    print("  counted bytes by op, largest first: " + ", ".join(
        f"{n} {b / 1e9:.4f} GB ({c} calls)" for n, (c, b) in top))
    print(f"crosscheck (cuda) decode: counted {d['compiled_bytes'] / 1e9:.4f}"
          f" GB, {d['compiled_flops'] / 1e9:.3f} GFLOP vs modeled "
          f"{d['modeled']['total_bytes'] / 1e9:.4f} GB: ratio "
          f"{d['ratio']:.4f} in band [{lo:g}, {hi:g}]: "
          f"{'yes' if d['within_band'] else 'NO'} ({cc_s:.2f}s) | executed"
          f" step under the counter: {len(run.ops)} ops ({kernels} K1 "
          f"calls) equal to the meta count op for op")
    return d


def dry_peak_against_card(eng) -> dict:
    """Phase 13c: the decode step as a one-rank dry-run cell (meta
    copies, MemTracker) against the executed step's
    ``max_memory_allocated``."""
    from repro_torch.launch.dryrun import count_cell
    fn, args, kw = eng.traffic.step_call("decode")
    _, mem = count_cell(lambda: fn(*args, **kw), {"args": args, "kw": kw})
    # engines deleted earlier hold their tensors through reference
    # cycles until the cyclic collector runs
    gc.collect()
    fn, args, kw = eng.traffic.step_call("decode", meta=False)
    sync()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(*args, **kw)
    sync()
    peak = torch.cuda.max_memory_allocated()
    gap = peak - mem["peak_bytes"]
    print(f"dry-run one-rank decode cell: peak {mem['peak_bytes'] / 2**30:.4f}"
          f" GiB (inputs {mem['argument_bytes'] / 2**30:.4f} GiB + temps "
          f"{mem['temp_bytes'] / 2**20:.2f} MiB; computed on meta tensors) "
          f"| the card: max_memory_allocated {peak / 2**30:.4f} GiB "
          f"(resident before the step {resident / 2**30:.4f} GiB, temps "
          f"{(peak - resident) / 2**20:.2f} MiB) | gap {gap / 2**20:.2f} MiB "
          f"({100 * gap / peak:.2f} % of the card's peak)")
    return {"dry_peak": mem["peak_bytes"], "dry_args": mem["argument_bytes"],
            "card_peak": peak, "card_resident": resident}


def dryrun_cell_on_host() -> float:
    """Phase 13d: one production dry-run cell on the host, in a process
    of its own (a fake world of 256 ranks); prints its record line."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "CUDA_VISIBLE_DEVICES": ""}
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "olmo-1b", "--shape", "decode_32k", "--out", out],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        line = next(ln for ln in run.stdout.splitlines()
                    if ln.startswith("[OK]"))
        with open(os.path.join(out, "olmo-1b__decode_32k__16x16.json")) as f:
            rec = json.load(f)
    secs = time.perf_counter() - t0
    mem = rec["memory_analysis"]
    print(f"dry run on the host ({secs:.1f}s with the process start; "
          f"computed on meta tensors): {line}")
    print(f"  olmo-1b decode_32k per rank of 16x16: stored "
          f"{mem['argument_bytes'] / 1e9:.3f} GB, peak "
          f"{mem['peak_bytes'] / 1e9:.1f} GB (the gathered cache), wire "
          f"{rec['collectives']['wire_bytes'] / 1e9:.1f} GB, "
          f"{rec['flops_per_device'] / 1e12:.3f} TFLOP")
    return secs


def sampled_phase(cfg, device, gen) -> list:
    """Phase 13; returns the path records (by kernel) of its three
    served runs."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, num_slots=4, max_len=256, sparsity=0.5, seed=0,
                      device=device)
    assert_no_dense_copy(eng)
    trace = sampled_trace(cfg.vocab_size)
    greedy = [{k: v for k, v in spec.items()
               if k not in ("temperature", "top_k", "seed")}
              for spec in trace]
    base = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                       head_sparsity=eng.head_sparsity, device=device)
    grep = serve(base, greedy, f"{cfg.name} the same trace all greedy, "
                               f"contiguous (same weights)")
    paths = [check_counts(base, grep, f"{cfg.name}, greedy, contiguous")]
    greedy_ms = 1e3 * grep["wall_s"] / base.decode_steps
    del base
    gc.collect()
    rep = serve(eng, trace, f"{cfg.name} sampled + greedy, contiguous")
    paths.append(check_counts(eng, rep, f"{cfg.name}, sampled, contiguous"))
    print(f"sampled against greedy (same weights and arrivals): "
          f"{rep['tok_per_s']:.1f} vs {grep['tok_per_s']:.1f} tok/s | wall "
          f"per decode step {1e3 * rep['wall_s'] / eng.decode_steps:.2f} vs "
          f"{greedy_ms:.2f} ms")
    if cfg.name == "olmo-1b":
        assert per_step(eng)["bitmap_spmm"] == 113
    decode_step_check(eng, gen)
    paged = ServeEngine(cfg, num_slots=4, max_len=256, params=eng.params,
                        head_sparsity=eng.head_sparsity, paged=True,
                        page_len=16, device=device)
    prep = serve(paged, trace, f"{cfg.name} sampled + greedy, paged")
    paths.append(check_counts(paged, prep, f"{cfg.name}, sampled, paged"))
    paged.kv.audit()
    same = sum(a == b for a, b in zip(rep["tokens"], prep["tokens"]))
    print(f"paged vs contiguous: {same} of {len(trace)} requests served "
          f"the same tokens (bf16; sampled draws replay the same keys)")
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    sampler_check(eng)
    crosscheck_on_card(eng)
    dry_peak_against_card(eng)
    del eng
    torch.cuda.empty_cache()
    dryrun_cell_on_host()
    return paths


def phase(label: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[{label}: {now - t0:.1f}s]")
    return now


def run(olmo_cfg, granite_cfg, gemma_cfg, device, gen,
        olmo_shapes=OLMO_SHAPES, granite_shapes=GRANITE_SHAPES,
        expert_shapes=GRANITE_EXPERT_SHAPES, attn=None,
        rows=MATMUL_ROWS, timed_rows=(4, 2048), rwkv_cfg=None,
        jamba_cfg=None, jamba_smoke=None, ssm_shapes=SSM_SHAPES,
        mix_b_shapes=MIX_B_SHAPES, sharded_cases=SHARDED_CASES,
        sharded_expert_cases=SHARDED_EXPERT_CASES,
        smi: str = "", musicgen_cfg=None, decode_cases=None) -> dict:
    """Phases 2-13 (11 with ``musicgen_cfg``); returns the kernels
    record.  A kernel's ``launches``
    sums its ``paths`` (each path's run with the counts set to 0 just
    before it).  K1's and K1g's ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are one decode step's calls at M = 4; K2's are
    olmo-1b's bf16 causal shape, K3's / K4's the gate/up weight at
    M = 4 and decode attention's olmo-1b's longgen shape (phase 5b,
    ``decode_cases`` or ``decode_attention_cases``), with every timed
    shape under ``timings`` (``ms_scope``)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    t = time.perf_counter()
    worst = {"bitmap_spmm": max(
        kernel_against_plain(device, gen, olmo_shapes, ROWS, SPARSITIES),
        kernel_against_plain(device, gen, granite_shapes, GRANITE_ROWS,
                             GRANITE_SPARSITIES),
        kernel_against_plain(device, gen, ssm_shapes, SSM_ROWS,
                             SSM_SPARSITIES),
        sharded_against_plain(device, gen, sharded_cases, (1, 4)))}
    worst["bitmap_spmm_grouped"] = max(
        kernel_against_plain(device, gen, expert_shapes, GRANITE_ROWS,
                             GRANITE_SPARSITIES,
                             groups=granite_cfg.num_experts),
        grouped_edge_cases(device, gen, expert_shapes, GRANITE_ROWS,
                           granite_cfg.num_experts),
        kernel_against_plain(device, gen, mix_b_shapes, SSM_ROWS,
                             SSM_SPARSITIES, groups=5),
        sharded_against_plain(device, gen, sharded_expert_cases, (1, 4),
                              groups=granite_cfg.num_experts))
    print(f"kernels against plain: {dict(LAUNCHES)} comparison launches, "
          f"max |kernel - plain| {worst}")
    reset_launches()
    t = phase("phase 2, kernels against plain", t)

    olmo, olmo_paths, shared = olmo_engine_phase(olmo_cfg, device, gen)
    olmo_times = olmo_timing_phase(olmo, device, gen)
    torch.cuda.empty_cache()
    t = phase(f"phase 3, {olmo_cfg.name}", t)

    eng, granite_paths, baseline = granite_engine_phase(granite_cfg,
                                                             device, gen)
    g_times, whole = granite_timing_phase(eng, device, gen)
    del eng
    torch.cuda.empty_cache()
    t = phase(f"phase 4, {granite_cfg.name}", t)

    layer = kernel_layer_phase(olmo_cfg, gemma_cfg, device, gen, attn=attn,
                               rows=rows, timed_rows=timed_rows)
    t = phase("phase 5, kernels K2-K4 against their plain versions and "
              "timed", t)
    layer.update(decode_attention_phase(olmo_cfg, granite_cfg, gemma_cfg,
                                        device, gen, cases=decode_cases))
    for name, (_, err, _) in layer.items():
        worst[name] = err
    t = phase("phase 5b, decode attention against its plain version and "
              "timed", t)

    chaos_path = chaos_phase(olmo, shared, device, gen)
    telemetry_cost(olmo, chaos_trace(shared), device)
    lifecycle_pass(olmo, shared, device)
    del olmo
    torch.cuda.empty_cache()
    t = phase(f"phase 6, {olmo_cfg.name} under faults, audit and "
              f"telemetry", t)

    ssm = ssm_phase(rwkv_cfg, jamba_cfg, jamba_smoke, device, gen)
    torch.cuda.empty_cache()
    t = phase("phase 7, the recurrent mixers", t)

    trained = training_phase(olmo_cfg, device, gen, smi)
    print(f"phase 8a record ({smi}): "
          f"{json.dumps(trained['train'])}")
    t = phase("phase 8, training on the card", t)

    sharded = sharded_phase(olmo_cfg, device, smi)
    t = phase("phase 9, sharded serving over torch.distributed", t)

    sharded_training_phase(olmo_cfg, smi)
    t = phase("phase 10, sharded training over torch.distributed", t)

    music_paths, music_times = [], None
    if musicgen_cfg is not None:
        music_paths, music_times = musicgen_phase(musicgen_cfg, device, gen)
        t = phase(f"phase 11, {musicgen_cfg.name} (frames) through K1", t)

    example_paths = examples_phase(device)
    t = phase("phase 12, the examples on the card", t)

    sampled_paths = sampled_phase(olmo_cfg, device, gen)
    phase(f"phase 13, {olmo_cfg.name} sampled tokens, counts and the dry "
          f"run", t)

    def record(name, paths, times, scope, **extra):
        ms, plain_ms, b_ms, by, lib_ms = times
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": sum(p["launches"] for p in paths),
                "paths": paths, "max_abs_err": worst[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": lib_ms, "ms_scope": scope, **extra}

    k1_paths = ([p["bitmap_spmm"] for p in olmo_paths]
                + [chaos_path["bitmap_spmm"]]
                + [p["bitmap_spmm"] for p in granite_paths]
                + ssm["bitmap_spmm"] + [trained["bitmap_spmm"]] + sharded
                + [p["bitmap_spmm"] for p in music_paths]
                + [p for k, p in example_paths if k == "bitmap_spmm"]
                + [p["bitmap_spmm"] for p in sampled_paths])
    # decode attention on the engines' paths (the sharded ranks of phase 9
    # are not counted), then phase 5b's direct calls
    main_paths = {"decode_attention": (
        [p["decode_attention"] for p in olmo_paths]
        + [chaos_path["decode_attention"]]
        + [p["decode_attention"] for p in granite_paths]
        + [{"path": f"{granite_cfg.name}, baseline-mode decode step",
            "launches": baseline["decode_attention"],
            "launches_per_step": baseline["decode_attention"],
            "decode_steps": 1}]
        + ssm["decode_attention"] + [trained["decode_attention"]]
        + [p["decode_attention"] for p in music_paths]
        + [p for k, p in example_paths if k == "decode_attention"]
        + [p["decode_attention"] for p in sampled_paths])}
    k1g_paths = ([p["bitmap_spmm_grouped"] for p in granite_paths]
                 + ssm["bitmap_spmm_grouped"]
                 + [p for k, p in example_paths
                    if k == "bitmap_spmm_grouped"])
    g1 = g_times["bitmap_spmm"]
    g_k1_per_step = granite_paths[0]["bitmap_spmm"]["launches_per_step"]

    music = {}
    if music_times is not None:
        ms, plain_ms, b_ms, by, lib_ms = music_times
        music["musicgen"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": lib_ms,
            "ms_scope": f"one {musicgen_cfg.name} decode step: "
                        f"{music_paths[0]['bitmap_spmm']['launches_per_step']}"
                        f" launches at M=4"}

    def rwkv(name):
        ms, plain_ms, b_ms, by, lib_ms = ssm["times"][name]
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": by, "library_ms": lib_ms,
                "ms_scope": f"one {rwkv_cfg.name} decode step: "
                            f"{ssm[name][0]['launches_per_step']} launches "
                            f"at M=4"}

    return {"kernels": [
        record("bitmap_spmm", k1_paths, olmo_times,
               f"one {olmo_cfg.name} decode step: "
               f"{k1_paths[0]['launches_per_step']} launches at M=4",
               granite={"ms": g1[0], "plain_ms": g1[1], "bound_ms": g1[2],
                        "bound_by": g1[3], "library_ms": g1[4],
                        "ms_scope": f"one {granite_cfg.name} decode step: "
                                    f"{g_k1_per_step} launches at M=4"},
               rwkv6=rwkv("bitmap_spmm"), **music),
        record("bitmap_spmm_grouped", k1g_paths,
               g_times["bitmap_spmm_grouped"],
               f"one {granite_cfg.name} decode step: "
               f"{k1g_paths[0]['launches_per_step']} launches at G="
               f"{granite_cfg.num_experts}, M=4 per expert",
               whole_step={"ms": whole[0], "plain_ms": whole[1],
                           "bound_ms": whole[2], "bound_by": whole[3],
                           "library_ms": whole[4],
                           "ms_scope": "both kernels' launches of one "
                                       "decode step"},
               rwkv6=rwkv("bitmap_spmm_grouped"),
               baseline_mode_decode_step={
                   "launches": baseline["bitmap_spmm_grouped"],
                   "scope": f"one {granite_cfg.name} decode step in "
                            f"baseline mode (global MoE dispatch); a "
                            f"check, not counted in launches"})] + [
        record(name, main_paths.get(name, []) + [path],
               tuple(timings[0][key] for key in (
                   "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")),
               f"{timings[0]['shape']}, bf16; library "
               f"{timings[0]['library']}", timings=timings)
        for name, (path, _, timings) in layer.items()]}


def main() -> int:
    if sys.argv[1:2] == ["--phase9-rank"]:
        return phase9_rank(*sys.argv[2:4])
    if sys.argv[1:2] == ["--phase10-rank"]:
        return phase10_rank(*sys.argv[2:4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config, get_smoke_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = card_and_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = run(get_config("olmo-1b"), get_config("granite-moe-3b-a800m"),
                 get_config("gemma3-4b"), torch.device("cuda"), gen,
                 rwkv_cfg=get_config("rwkv6-3b"),
                 jamba_cfg=get_config("jamba-v0.1-52b"),
                 jamba_smoke=get_smoke_config("jamba-v0.1-52b"), smi=smi,
                 musicgen_cfg=get_config("musicgen-medium"))
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

#!/usr/bin/env python3
"""Quick card probe of K1, K1g and K2 (``src/repro_torch/kernels``).

Run from the root of the repository on a machine with one NVIDIA H100
and the CUDA toolkit:

    python3 scripts/probe_kernels.py

Builds the kernels (printing ptxas's registers and spills for the K1/K1g
and K2 variants), holds each against its plain version on seeded
inputs (K2's tensor path over head dims, groups, masks and lengths; K1
and K1g over row counts, near-empty and all-zero tiles and a budget with
budget % 4 != 0, and a split output written bit-identically twice), then
times, as CUDA-graph replays cycling input sets past the 50 MB L2:
K1g at granite-moe-3b-a800m's expert shapes (40 experts, M = 4; gate/up
at sparsity 0.25, down at 0.99, as global pruning leaves them), K1 at
olmo-1b's four decode shapes (sparsity 0.5) and granite's attention and
router shapes, and K2 at chip_smoke.py's four bf16 shapes on both paths.
Weights are random from a seed.  Exits non-zero on any disagreement.
A shorter check than ``chip_smoke.py``, for iterating on a kernel.

    python3 scripts/probe_kernels.py --plans 256x1,256x2,512x2

also times each K1/K1g shape under each forced (threads x ring stages)
plan beside the one ``bitmap_spmm.stream_plan`` picks, and with and
without thread block clusters (each checked against the plain version
first): the measurements behind the plan's rule.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def ptxas_lines(log: str) -> None:
    report = cs.ptxas_report(log)
    names = [n for n in report if "bitmap" in n or "flash" in n]
    plain = cs.demangle(names)
    for n in names:
        label = plain[n].replace("(anonymous namespace)::", "").split("(")[0]
        print(f"  {label}: {report[n][0]} registers, {report[n][1]} bytes "
              f"spilled")


def check_bitmap(gen, dev) -> None:
    from repro_torch.kernels import ops
    from repro_torch.sparse import pack_bitmap_experts, per_tensor_prune
    cases = [(1, 1536, 512, (128, 128), 0.99),
             (40, 512, 1536, (128, 128), 0.99),
             (40, 1536, 512, (128, 128), 0.25),
             (1, 2048, 2048, (128, 128), 0.5), (3, 96, 48, (96, 24), 0.5),
             (1, 1536, 40, (128, 40), 0.5), (7, 256, 384, (128, 128), 0.7),
             (2, 36, 16, (36, 16), 0.5)]     # X rows not 16-byte aligned
    for g, k, n, block, s in cases:
        w = per_tensor_prune(torch.randn(g, k, n, generator=gen, device=dev),
                             s)
        w[:, : block[0], : block[1]] = 0.0          # an all-zero tile
        bw = pack_bitmap_experts(w[None], block=block).period(0)
        if g == 7:   # an odd budget: most tiles' values start off 16 bytes
            bw = cs.with_budget(bw, bw.budget | 3)
        for m in (1, 4, 5, 8, 9, 130):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(g, m, k, generator=gen, device=dev).to(dt)
                if g == 1:
                    out = ops.bitmap_spmm(x[0], bw.period(0))[None]
                else:
                    out = ops.bitmap_spmm_grouped(x, bw)
                ref = ops.bitmap_spmm_grouped(x, bw, impl="torch")
                torch.cuda.synchronize()
                cs._compare(f"K1{'g' if g > 1 else ''} G={g} K={k} N={n} "
                            f"s={s} M={m} budget {bw.budget}", out, ref, k, dt)
                again = (ops.bitmap_spmm(x[0], bw.period(0))[None] if g == 1
                         else ops.bitmap_spmm_grouped(x, bw))
                assert torch.equal(out, again), "not bit-identical"
        print(f"  K1/K1g G={g} K={k} N={n} block {block} sparsity {s} budget "
              f"{bw.budget}: agrees at M 1-130, f32 and bf16, bit-identical "
              f"twice")


def check_attention(gen, dev) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    for b, hq, hkv, sq, skv, d, causal, window in [
            (2, 4, 4, 128, 128, 64, True, None),
            (2, 4, 2, 256, 256, 32, True, 64),
            (1, 8, 2, 300, 300, 256, True, 100),
            (1, 4, 2, 200, 130, 128, False, None),
            (1, 2, 1, 70, 50, 64, True, 8),
            (1, 4, 1, 1, 77, 128, False, None),
            (1, 8, 4, 257, 300, 256, False, 40),
            (2, 16, 16, 2048, 2048, 128, True, None)]:
        q = torch.randn(b, hq, sq, d, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, hkv, skv, d, generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        ref = ops.flash_attention(q, k, v, impl="torch", causal=causal,
                                  window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 5e-2, (b, hq, hkv, sq, skv, d, causal, window, err)
        print(f"  K2 tensor B{b} H{hq}/{hkv} S{sq}/{skv} D{d} causal "
              f"{causal} window {window}: max |diff| {err:.3g}")


def forced_plans(plans):
    """(label, stream_plan replacement) for the plan picked, each forced
    (threads, stages) and, with clusters off, the plan picked."""
    from repro_torch.kernels import bitmap_spmm as k1
    picked = k1.stream_plan

    def forced(threads, stages):
        def plan(*args):   # stream_plan's arguments up to per_sm
            got = k1.plan_with(*args[:11], threads, stages)
            if got is None:
                raise ValueError("does not fit")
            return got
        return plan

    return ([("picked", picked)]
            + [(f"{t}x{s}", forced(t, s)) for t, s in plans]
            + [("no clusters", lambda *args: picked(*args[:11]))])


def time_bitmap(gen, dev, plans=()) -> None:
    from repro_torch.kernels import bitmap_spmm as k1
    from repro_torch.kernels import ops
    from repro_torch.sparse import (pack_bitmap, pack_bitmap_experts,
                                    per_tensor_prune)
    rows = [("K1g gate/up", 40, 1536, 512, 0.25),
            ("K1g down", 40, 512, 1536, 0.99),
            ("K1 qkvo", 0, 2048, 2048, 0.5), ("K1 gate_up", 0, 2048, 8192, 0.5),
            ("K1 down", 0, 8192, 2048, 0.5), ("K1 head", 0, 2048, 50304, 0.5),
            ("K1 q_o", 0, 1536, 1536, 0.25), ("K1 k_v", 0, 1536, 512, 0.25),
            ("K1 router", 0, 1536, 40, 0.25)]
    for name, g, k, n, s in rows:
        block = (128, 40) if n == 40 else (128, 128)
        lead = (g,) if g else ()
        w = per_tensor_prune(torch.randn(*lead, k, n, generator=gen,
                                         device=dev), s)
        bw = (pack_bitmap_experts(w[None], block=block).period(0) if g
              else pack_bitmap(w, block=block))
        del w
        x = torch.randn(*lead, 4, k, generator=gen, device=dev).bfloat16()
        moved, ops_ = cs.call_bound(x, bw)
        sets = [(x, bw)] + [
            (x.clone(), type(bw)(bw.packed_bits.clone(), bw.values.clone(),
                                 bw.row_start.clone(), bw.shape, bw.block))
            for _ in range(cs._copies(moved) - 1)]
        fn = ops.bitmap_spmm_grouped if g else ops.bitmap_spmm
        b_ms, by = cs.bound_ms(moved, ops_)
        kt, nt = bw.packed_bits.shape[-4:-2]
        plan = k1._plan(max(g, 1), 4, kt, nt, *block, bw.budget, 4, 2,
                        k1._build.sm_count(dev), 1, 0)
        t = cs.graph_ms(lambda: [fn(a, wt) for a, wt in sets],
                        20) / len(sets)
        print(f"  {name} {tuple(x.shape)} x {bw.shape} budget {bw.budget}: "
              f"{1e3 * t:.1f} us | bound {1e3 * b_ms:.1f} us ({by}) = "
              f"{100 * b_ms / t:.1f}% | {moved / t / 1e6:.0f} GB/s | plan "
              f"{plan.threads} threads x {plan.blocks} blocks, "
              f"{plan.stages} stage(s), chunk {plan.chunk}, cluster "
              f"{plan.cluster}")
        if plans:
            picked, timed = k1.stream_plan, []
            for label, planner in forced_plans(plans):
                k1.stream_plan = planner
                k1._plan.cache_clear()
                try:
                    cs._compare(f"{name} {label}", fn(x, bw),
                                fn(x, bw, impl="torch"), k, x.dtype)
                    t = cs.graph_ms(lambda: [fn(a, wt) for a, wt in sets],
                                    20) / len(sets)
                    timed.append(f"{label} {1e3 * t:.1f}")
                except ValueError:
                    timed.append(f"{label} -")
                finally:
                    k1.stream_plan = picked
            k1._plan.cache_clear()
            print(f"    us by plan: {' | '.join(timed)}")
        del sets, bw


def time_attention(gen, dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    for label, b, hq, hkv, s, d, window, dt in cs.attention_cases(
            get_config("olmo-1b"), get_config("gemma3-4b")):
        if dt != torch.bfloat16:
            continue
        q = torch.randn(b, hq, s, d, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=dev).to(dt)
                for _ in range(2))
        pairs = b * hq * fa.live_pairs(s, s, True, window)
        res = {}
        for path in ("tensor", "fma"):
            res[path] = cs.graph_ms(lambda: fa.flash_attention(
                q, k, v, window=window, path=path), 10)
        print(f"  K2 {label} {tuple(q.shape)} window {window}: tensor "
              f"{res['tensor']:.4f} ms "
              f"({4 * d * pairs / res['tensor'] / 1e9:.1f} TFLOP/s) | fma "
              f"{res['fma']:.4f} ms")


def main() -> int:
    plans = ()
    if "--plans" in sys.argv:
        plans = [tuple(map(int, p.split("x"))) for p in
                 sys.argv[sys.argv.index("--plans") + 1].split(",")]
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    built = _build.build()
    print(f"build {built.seconds:.1f}s")
    ptxas_lines(built.log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    check_attention(gen, dev)
    check_bitmap(gen, dev)
    time_bitmap(gen, dev, plans)
    time_attention(gen, dev)
    print("probe_kernels: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

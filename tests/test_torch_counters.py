"""Port's op counter (``repro_torch.launch.counters``) and the traffic
ledger's cross-check against the JAX package's HLO analyzer.

The reference's analytic cases (``tests/test_hlo_counters.py``): a
matmul's FLOPs exact, a loop's ops times its trips, a sliced stacked
input charged at the slice, a cache update at the update.  The kernel
entry points count as one op each, on meta tensors and executed alike.
The port's dense unsharded olmo smoke decode and train steps, counted on
meta tensors, are held to the reference's ``hlo_counters.analyze`` of
its steps lowered outside a mesh (decode within 2 %, train to the one
head product the port's loss checkpoint recomputes).  ``crosscheck()``
on olmo and granite smoke over the reference's four knob sets: the
counted bytes at or above the modeled floor, inside the reference's
bands, and the meta count equal, op for op, to the count of the
executed step.
"""
import warnings

import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.launch.hlo_counters import analyze
from repro.models import model as ref_M
from repro.serve import ServeEngine as RefEngine
from repro.train.optimizer import OptConfig as RefOptConfig
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.nm_spmm import nm_spmm
from repro_torch.launch import steps as pt_steps
from repro_torch.launch.counters import OpCounter, to_meta
from repro_torch.models.model import cache_structs, param_structs
from repro_torch.serve import ServeEngine as PtEngine
from repro_torch.serve.traffic import CROSSCHECK_BANDS
from repro_torch.sparse.format import (pack_bitmap, pack_bitmap_experts,
                                       pack_block_sparse)
from repro_torch.sparse.nm import pack_nm, prune_nm
from repro_torch.sparse.pruning import per_tensor_prune
from repro_torch.train import optimizer as pt_opt

META = "meta"


def count(fn, *args, dispatch="torch"):
    """``fn(*args)`` under a fresh counter: (its result, the counter)."""
    with OpCounter(dispatch) as c:
        out = fn(*args)
    return out, c


def _rand(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------- analytic (reference) ----


@pytest.mark.parametrize("device", ["cpu", META])
def test_matmul_flops_exact(device):
    a = torch.empty(128, 64, device=device)
    b = torch.empty(64, 32, device=device)
    _, c = count(lambda: a @ b)
    assert c.result()["flops"] == 2 * 128 * 64 * 32
    # operands plus output, float32
    assert c.result()["bytes"] == 4 * (128 * 64 + 64 * 32 + 128 * 32)
    assert [name for name, _, _ in c.ops] == ["mm"]


def test_loop_ops_times_trips():
    """The reference multiplies a scan body by its trip count; an eager
    loop dispatches its body that many times."""
    x, w = torch.empty(32, 32, device=META), torch.empty(32, 32, device=META)

    def f(x):
        for _ in range(9):
            x = torch.tanh(x @ w)
        return x
    _, c = count(f, x)
    assert c.result()["flops"] == 2 * 32 ** 3 * 9
    assert [n for n, _, _ in c.ops].count("mm") == 9


def test_sliced_stacked_input_not_charged_whole():
    """Walking a stacked (P, D, D) weight: each step reads its slice, so
    the traffic is O(P · slice), never O(P · stack)."""
    p, d = 16, 64
    ws = torch.empty(p, d, d, device=META)

    def f(x):
        for i in range(p):
            x = torch.tanh(x @ ws[i])
        return x
    _, c = count(f, torch.empty(d, d, device=META))
    stack = p * d * d * 4
    assert c.result()["bytes"] < 8 * stack, c.result()["bytes"] / stack
    mms = [b for n, _, b in c.ops if n == "mm"]
    assert mms == [3 * d * d * 4] * p


def test_cache_update_charged_at_update_size():
    """Decode-style cache writes (a slice ``copy_`` and an
    ``index_put_``): each charged twice the update (plus its index),
    not the buffer."""
    steps, cap, d = 8, 256, 64
    cache = torch.zeros(cap, d)
    upd = torch.ones(1, d)
    idx = torch.tensor([3])

    def f():
        for i in range(steps):
            cache[i:i + 1].copy_(upd)
            cache.index_put_((idx + i,), upd)
    _, c = count(f)
    buffer = cap * d * 4
    assert c.result()["bytes"] < 6 * buffer
    writes = {n: b for n, _, b in c.ops if n in ("copy_", "index_put_")}
    assert writes == {"copy_": 2 * d * 4, "index_put_": 2 * d * 4 + 8}


# --------------------------------------------------------- entry points ----


def _entry_cases():
    k, n, m = 64, 48, 5
    w = per_tensor_prune(_rand(k, n, seed=1), 0.5)
    bw = pack_bitmap(w, (16, 16), cache_dense=True)
    ge = per_tensor_prune(_rand(1, 3, k, n, seed=2), 0.5)
    gbw = pack_bitmap_experts(ge, (16, 16), cache_dense=True).period(0)
    bs = pack_block_sparse(w, (16, 16))
    nm = pack_nm(prune_nm(w, 1, 4), 1, 4, (16, 16))
    x = _rand(m, k, seed=3)
    q, kk, v = _rand(1, 4, 8, 16), _rand(1, 2, 8, 16), _rand(1, 2, 8, 16)
    dq, dk, dv = _rand(3, 1, 4, 16), _rand(3, 12, 2, 16), _rand(3, 12, 2, 16)
    return [
        ("bitmap_spmm", lambda x, w: ops.bitmap_spmm(x, w), (x, bw),
         2 * m * k * n),
        ("bitmap_spmm_grouped", lambda x, w: ops.bitmap_spmm_grouped(x, w),
         (_rand(3, m, k, seed=4), gbw), 2 * 3 * m * k * n),
        ("block_sparse_matmul", lambda x, w: ops.block_sparse_matmul(x, w),
         (x, bs), 2 * m * k * n),
        ("nm_spmm", lambda x, w: nm_spmm(x, w), (x, nm), 2 * m * k * n),
        ("flash_attention",
         lambda q, k, v: ops.flash_attention(q, k, v, window=4),
         (q, kk, v), 4 * 4 * 8 * 8 * 16),
        ("decode_attention",
         lambda q, k, v, pos: ops.decode_attention(q, k, v, pos, window=6),
         (dq, dk, dv, torch.tensor([0, 5, 30])), 4 * 3 * 4 * 12 * 16),
    ]


@pytest.mark.parametrize("case", _entry_cases(), ids=lambda c: c[0])
def test_entry_point_is_one_op_on_meta_and_executed(case):
    """An entry point is one op, its FLOPs dense: executed on the CPU
    (the plain version, nothing inside counted) and on meta tensors (an
    empty result of the right shape) the count is the same; with the
    card's dispatch a bitmap weight is charged its ``hbm_bytes``."""
    name, fn, args, flops = case
    out, c = count(fn, *args)
    assert [n for n, _, _ in c.ops] == [name]
    assert c.result()["flops"] == flops
    mout, mc = count(fn, *to_meta(args))
    assert mout.device.type == META and mout.shape == out.shape
    assert mout.dtype == out.dtype
    assert mc.ops == c.ops
    _, cc = count(fn, *to_meta(args), dispatch="cuda")
    if name.startswith("bitmap"):
        w = args[1]
        x_out = c.ops[0][2] - w.dense_cache.numel() * 4
        assert cc.ops[0][2] == x_out + w.hbm_bytes
    # no counter: the entry point runs as before
    torch.testing.assert_close(fn(*args), out, rtol=0, atol=0)


def test_decode_attention_on_meta_is_one_op_charged_the_whole_cache():
    """``ops.decode_attention`` on meta tensors: one op of 4·B·Hq·C·D
    FLOPs charged q's, both whole caches' (the reference's count of its
    einsums reads every line) and the output's bytes, whatever the
    dispatch."""
    b, c, hq, hkv, d = 3, 40, 6, 2, 64
    bf16 = torch.bfloat16
    q = torch.empty(b, 1, hq, d, dtype=bf16, device=META)
    kc, vc = (torch.empty(b, c, hkv, d, dtype=bf16, device=META)
              for _ in range(2))
    pos = torch.empty(b, dtype=torch.int64, device=META)
    want = [("decode_attention", 4.0 * b * hq * c * d,
             2 * (b * hq * d * 2) + 2 * (b * c * hkv * d * 2))]
    for dispatch in ("torch", "cuda"):
        out, cnt = count(lambda: ops.decode_attention(q, kc, vc, pos,
                                                      ring=True, window=c),
                         dispatch=dispatch)
        assert cnt.ops == want
        assert out.device.type == META and out.shape == q.shape
        assert out.dtype == bf16


# ------------------------------------------------ steps vs the reference ----


def _ref_serve_flops(cfg):
    step = jax.jit(ref_steps.build_serve_step(cfg))
    low = step.lower(ref_M.param_structs(cfg), ref_M.cache_structs(cfg, 4, 64),
                     jax.ShapeDtypeStruct((4, 1), jnp.int32),
                     jax.ShapeDtypeStruct((4,), jnp.int32))
    return analyze(low.compile().as_text())["flops"]


def _ref_train_flops(cfg):
    ps = ref_M.param_structs(cfg)
    f32 = lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32)
    opt = {"m": jax.tree.map(f32, ps), "v": jax.tree.map(f32, ps),
           "step": jax.ShapeDtypeStruct((), jnp.int32)}
    batch = {k: jax.ShapeDtypeStruct((4, 64), jnp.int32)
             for k in ("tokens", "targets")}
    step = jax.jit(ref_steps.build_train_step(cfg, RefOptConfig()))
    return analyze(step.lower(ps, opt, batch).compile().as_text())["flops"]


def test_olmo_decode_and_train_flops_equal_reference():
    """The dense unsharded olmo smoke decode step (4 slots, a 64-deep
    cache) and train step (4 × 64), counted on meta tensors, against the
    reference's ``hlo_counters`` of its jitted steps lowered outside a
    mesh.  Decode: within 2 %.  Train: the reference's count plus
    exactly one head product, 2·B·S·D·V: the port recomputes the loss
    chunk's head product under its ``checkpoint`` in the backward pass,
    where XLA merges the rematerialised product with the forward one
    when the loss loop has one trip (S = 64 < ``loss_chunk``)."""
    cfg, rcfg = pt_smoke("olmo-1b"), ref_smoke("olmo-1b")
    meta = lambda shape: torch.empty(shape, dtype=torch.int64, device=META)
    _, c = count(pt_steps.build_serve_step(cfg), param_structs(cfg),
                 cache_structs(cfg, 4, 64), meta((4, 1)), meta((4,)))
    want = _ref_serve_flops(rcfg)
    assert c.result()["flops"] == pytest.approx(want, rel=0.02)

    ps = param_structs(cfg)
    batch = {"tokens": meta((4, 64)), "targets": meta((4, 64))}
    step = pt_steps.build_train_step(cfg, pt_opt.OptConfig())
    with torch.enable_grad(), OpCounter() as tc:
        step(ps, pt_opt.init(ps), batch)
    want = _ref_train_flops(rcfg)
    assert 64 < cfg.loss_chunk
    head = 2 * 4 * 64 * cfg.d_model * cfg.vocab_size
    assert tc.result()["flops"] == want + head


# ------------------------------------------------------------ crosscheck ----

KNOBS = {
    "packed-contig": dict(stream_weights=True, bitmap_head=True),
    "dense-contig": dict(stream_weights=False, bitmap_head=False),
    "packed-paged": dict(stream_weights=True, bitmap_head=True, paged=True,
                         page_len=8),
    "packed-paged-prefill": dict(stream_weights=True, bitmap_head=True,
                                 paged=True, page_len=8, prefill_chunk=8),
}


def _pt_engine(arch, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # granite's head fallback
        return PtEngine(pt_smoke(arch), seed=0, num_slots=2, max_len=32,
                        sparsity=0.5, device="cpu", **kw)


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("knobs", list(KNOBS))
def test_crosscheck_counts_within_reference_band(arch, knobs):
    eng = _pt_engine(arch, **KNOBS[knobs])
    # sampled slots too: the sampler's ops are on the counted path
    eng.submit([1, 2, 3], 2, temperature=0.8, seed=5)
    eng.submit([4, 5], 2, top_k=3, temperature=1.0, seed=6)
    eng.step()
    cc = eng.traffic.crosscheck()
    assert cc["dispatch"] in ("xla-oracle", "dense")
    assert ("prefill" in cc) == bool(KNOBS[knobs].get("prefill_chunk"))
    for phase in ("decode", "prefill"):
        if phase not in cc:
            continue
        e = cc[phase]
        lo, hi = CROSSCHECK_BANDS[phase]
        assert e["tolerance"] == [lo, hi]
        assert e["compiled_bytes"] > 0 and e["compiled_flops"] > 0
        # the modeled side is a fetch floor
        assert e["ratio"] >= lo, (phase, e)
        assert e["within_band"] == (lo <= e["ratio"] <= hi)
        assert e["within_band"], (phase, e["ratio"])
        # op for op: the meta count is the executed step's count
        meta, run = eng.traffic.count(phase), eng.traffic.count(
            phase, meta=False)
        assert meta.ops == run.ops
    assert eng.report()["traffic"]["crosscheck"] is cc


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m"])
def test_crosscheck_flops_equal_reference_engine(arch):
    """On the paged chunked-prefill engine, whose compiled cross-check
    runs on this tree, the counted FLOPs of decode and prefill equal the
    reference engine's within 2 %."""
    kw = KNOBS["packed-paged-prefill"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = RefEngine(ref_smoke(arch), seed=0, num_slots=2, max_len=32,
                        sparsity=0.5, **kw)
    want = ref.traffic.crosscheck()
    got = _pt_engine(arch, **kw).traffic.crosscheck()
    for phase in ("decode", "prefill"):
        assert got[phase]["compiled_flops"] == pytest.approx(
            want[phase]["compiled_flops"], rel=0.02), phase

"""Port's bitmap_spmm against the JAX package's kernel (interpret mode)
and oracle, and — on a card — the CUDA kernel against its plain version.
"""
import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.bitmap_spmm import bitmap_spmm as ref_kernel
from repro.kernels.bitmap_spmm import hbm_traffic_model as ref_traffic
from repro.sparse import pack_bitmap as ref_pack
from repro.sparse import pack_bitmap_experts as ref_pack_experts
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels import bitmap_spmm as pt_kernel
from repro_torch.sparse import pack_bitmap as pt_pack
from repro_torch.sparse import pack_bitmap_experts as pt_pack_experts

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-3


def _case(m, k, n, sparsity, seed):
    r = np.random.default_rng(seed)
    w = r.standard_normal((k, n)).astype(np.float32)
    w *= r.random((k, n)) >= sparsity
    x = r.standard_normal((m, k)).astype(np.float32)
    return w, x


def _both(w, x, block, dname):
    jdt, tdt = DTYPES[dname]
    ref_bw = ref_pack(np.asarray(jnp.asarray(w, jdt)), block=block)
    pt_bw = pt_pack(torch.from_numpy(w).to(tdt), block=block)
    return (jnp.asarray(x, jdt), ref_bw), (torch.from_numpy(x).to(tdt), pt_bw)


def _close(a, b, k, dname):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=_tol(dname) * np.sqrt(k), rtol=1e-2)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("m,k,n,block", [
    (128, 128, 128, (128, 128)),
    (128, 256, 256, (128, 128)),
    (256, 128, 256, (64, 128)),
    (128, 384, 128, (128, 64)),
])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparsity", [0.5, 0.75, 0.95])
def test_bitmap_spmm_sweep(m, k, n, block, dname, sparsity):
    w, x = _case(m, k, n, sparsity, seed=hash((m, k, n, sparsity)) % 2**32)
    (rx, rw), (px, pw) = _both(w, x, block, dname)
    out = ops.bitmap_spmm(px, pw)
    assert out.dtype == px.dtype and out.shape == (m, n)
    _close(_np(out), ref_ref.bitmap_spmm_ref(rx, rw), k, dname)
    _close(_np(out), ref_kernel(rx, rw, interpret=True), k, dname)


@pytest.mark.parametrize("m", [1, 4, 12, 130])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_bitmap_spmm_decode_rows_and_head_shape(m, dname):
    """The head shape (K=64, N=256, block (64, 128)) at decode-sized and
    ragged M, with (B, 1, K) activations as the decode step passes them."""
    k, n = 64, 256
    w, x = _case(m, k, n, 0.6, seed=m)
    (rx, rw), (px, pw) = _both(w, x, (64, 128), dname)
    out = ops.bitmap_spmm(px[:, None, :], pw)
    assert out.shape == (m, 1, n)
    _close(_np(out[:, 0]), ref_ref.bitmap_spmm_ref(rx, rw), k, dname)
    _close(_np(out[:, 0]), ref_kernel(rx, rw, interpret=True), k, dname)


def test_plain_version_matches_oracle_exactly_in_f32():
    """Same decompression, same f32 product: the plain version agrees
    with the JAX oracle to float32 rounding of the sums."""
    w, x = _case(8, 256, 128, 0.5, seed=11)
    (rx, rw), (px, pw) = _both(w, x, (128, 64), "float32")
    np.testing.assert_allclose(_np(ops.bitmap_spmm(px, pw, impl="torch")),
                               np.asarray(ref_ref.bitmap_spmm_ref(rx, rw)),
                               rtol=1e-5, atol=1e-5)


def test_out_dtype_and_dense_cache():
    w, x = _case(4, 128, 128, 0.5, seed=2)
    bw = pt_pack(torch.from_numpy(w), block=(128, 128), cache_dense=True)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = ops.bitmap_spmm(xb, bw, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    expect = xb.float() @ torch.from_numpy(w).to(torch.bfloat16).float()
    torch.testing.assert_close(out, expect)


def test_cpu_tensor_never_reaches_the_kernel():
    """A CPU tensor takes the plain version and counts no launch; asking
    the CUDA kernel for a CPU tensor raises instead of falling back."""
    w, x = _case(4, 128, 128, 0.5, seed=3)
    bw = pt_pack(torch.from_numpy(w), block=(128, 128))
    reset_launches()
    ops.bitmap_spmm(torch.from_numpy(x), bw)
    assert LAUNCHES["bitmap_spmm"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.bitmap_spmm(torch.from_numpy(x), bw, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.bitmap_spmm(torch.from_numpy(x), bw, impl="pallas")


def test_hbm_traffic_model_matches_reference():
    w, _ = _case(1, 512, 512, 0.75, seed=1)
    ref = ref_traffic((4, 512), ref_pack(w, block=(128, 128)))
    pt = pt_kernel.hbm_traffic_model((4, 512),
                                     pt_pack(torch.from_numpy(w),
                                             block=(128, 128)))
    assert ref == pt


@pytest.mark.parametrize("g", [1, 5, 8])
@pytest.mark.parametrize("m", [1, 4, 12])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_bitmap_spmm_grouped_matches_reference(g, m, dname):
    """The port's grouped dispatch on the CPU (its plain version) against
    the reference's grouped kernel in interpret mode and its oracle."""
    k, n, block = 64, 48, (32, 24)
    r = np.random.default_rng(100 * g + m)
    w = r.standard_normal((1, g, k, n)).astype(np.float32)
    w *= r.random(w.shape) >= np.linspace(0.3, 0.9, g)[None, :, None, None]
    x = r.standard_normal((g, m, k)).astype(np.float32)
    jdt, tdt = DTYPES[dname]
    ref_bw = jax.tree.map(lambda a: a[0], ref_pack_experts(
        np.asarray(jnp.asarray(w, jdt)), block=block))
    pt_bw = pt_pack_experts(torch.from_numpy(w).to(tdt), block=block
                            ).period(0)
    rx, px = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    reset_launches()
    out = ops.bitmap_spmm_grouped(px, pt_bw)
    assert LAUNCHES["bitmap_spmm_grouped"] == 0
    assert out.dtype == px.dtype and out.shape == (g, m, n)
    for impl in ("pallas_interpret", "xla"):
        _close(_np(out), ref_ops.bitmap_spmm_grouped(rx, ref_bw, impl=impl),
               k, dname)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.bitmap_spmm_grouped(px, pt_bw, impl="cuda")


def test_grouped_traffic_model_is_g_calls_of_one_group():
    w = np.random.default_rng(0).standard_normal((1, 6, 256, 128)).astype(
        np.float32)
    bw = pt_pack_experts(torch.from_numpy(w), block=(128, 128)).period(0)
    one = pt_kernel.hbm_traffic_model((4, 256), bw.period(0))
    six = pt_kernel.hbm_traffic_model((6, 4, 256), bw)
    for key in ("x_bytes", "out_bytes", "w_sparse_bytes", "w_dense_bytes"):
        assert six["components"][key] == 6 * one["components"][key], key
    assert six["sparse_bytes"] == 6 * one["sparse_bytes"]


# The K1/K1g launch plan (``stream_plan``): a persistent grid splitting
# the flat tile list into equal ranges, partial output tiles folded by
# the last block to arrive.  The shapes are the served ones: granite's
# expert stacks (gate/up, and down at 0.99 sparsity), olmo-1b's
# projections, head and down, granite's router, and prefill rows.
PLAN_CASES = [
    # groups, m, kt, nt, bk, bn, budget, value bytes, X bytes
    (40, 4, 12, 4, 128, 128, 12500, 4, 2),    # granite gate/up, decode
    (40, 4, 4, 12, 128, 128, 300, 4, 2),      # granite down, 0.99 sparse
    (40, 64, 12, 4, 128, 128, 12500, 4, 2),   # granite gate/up, prefill
    (1, 4, 16, 16, 128, 128, 8400, 4, 2),     # olmo-1b qkvo
    (1, 4, 64, 16, 128, 128, 8415, 4, 2),     # olmo-1b down
    (1, 4, 16, 393, 128, 128, 8419, 4, 2),    # olmo-1b head
    (1, 4, 12, 1, 128, 40, 2626, 4, 2),       # granite router
    (1, 130, 16, 64, 128, 128, 16384, 4, 4),  # dense tiles, 17 row blocks
    (1, 1, 1, 1, 64, 8, 1, 2, 4),             # one tile
    (5, 9, 2, 2, 32, 24, 333, 4, 2),          # budget % 4 != 0
]


def _occupancy(rows, threads, smem):
    """Blocks per SM as shared memory and a 128-register thread allow."""
    return min(65536 // (128 * threads), pt_kernel.MAX_DYN_BYTES // smem)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_stream_plan_walks_every_tile_once(case):
    """Every block walks a non-empty range of whole chunks (a chunk
    divides KT), the ranges cover the tiles once and within an eighth of
    an equal share (or one chunk), ``block_of`` inverts
    ``range_start``, and the partial slots the kernel uses for split
    output tiles are distinct and inside the scratch ``partial_floats``
    sizes."""
    g, m, kt, nt, bk, bn, budget, vb, xb = case
    plan = pt_kernel.stream_plan(g, m, kt, nt, bk, bn, budget, vb, xb,
                                 sms=132, per_sm=_occupancy)
    rows = 4 if m <= 4 else 8
    assert plan.rows == rows
    assert plan.stages in (1, 2)
    assert plan.smem <= pt_kernel.MAX_DYN_BYTES
    assert plan.tiles == g * -(-m // rows) * nt * kt
    assert plan.outputs == plan.tiles // kt and kt % plan.chunk == 0
    assert plan.threads == (512 if plan.tiles <= 132 else 256)
    slots = 132 * _occupancy(rows, plan.threads, plan.smem)
    assert 1 <= plan.blocks <= min(plan.tiles // plan.chunk, slots)
    starts = [pt_kernel.range_start(plan, b) for b in range(plan.blocks + 1)]
    assert starts[0] == 0 and starts[-1] == plan.tiles
    sizes = [b - a for a, b in zip(starts, starts[1:])]
    assert min(sizes) >= 1 and all(n % plan.chunk == 0 for n in sizes)
    assert max(sizes) <= max(1.125 * plan.tiles / min(slots, plan.tiles),
                             plan.chunk)
    for b in range(plan.blocks):
        for t in {starts[b], starts[b + 1] - 1}:
            assert pt_kernel.block_of(plan, t) == b
    used = set()
    for o in range(plan.outputs):
        b0 = pt_kernel.block_of(plan, o * kt)
        b1 = pt_kernel.block_of(plan, o * kt + kt - 1)
        if b0 == b1:
            continue
        for b in range(b0, b1 + 1):
            slot = 2 * b + (0 if o == starts[b] // kt else 1)
            assert slot not in used
            used.add(slot)
    assert all((s + 1) * rows * bn <= plan.partial_floats for s in used)


def test_chunks_keep_k_ranges_whole_where_that_balances():
    """granite's 0.99-sparse down (KT 4) gets whole K ranges per block
    (no fold), its gate/up (KT 12) chunks of 4 tiles."""
    occ = _occupancy
    down = pt_kernel.stream_plan(40, 4, 4, 12, 128, 128, 300, 4, 2,
                                 sms=132, per_sm=lambda *_: 1)
    assert down.chunk == 4
    up = pt_kernel.stream_plan(40, 4, 12, 4, 128, 128, 12500, 4, 2,
                               sms=132, per_sm=occ)
    assert up.chunk == 4 and up.blocks == 264 and up.stages == 1


@pytest.mark.parametrize("budget,vbytes,bk,bn,rows,xbytes", [
    (16384, 4, 128, 128, 8, 4),  # a dense tile, 8 rows
    (8419, 4, 128, 128, 4, 2),   # olmo-1b at sparsity 0.5, decode
    (300, 4, 128, 128, 4, 2),    # 0.99 sparse: small stages
    (333, 2, 32, 24, 8, 4),      # bf16 values, odd budget and tile
])
def test_stage_layout_fits_the_windows(budget, vbytes, bk, bn, rows, xbytes):
    """The values', bitmap's and row starts' 16-byte copy windows (up to
    15 bytes more than their own) fit before the next part, every part
    starts on 16 bytes, X's slice ends the stage, and the ring is as deep
    as shared memory allows beside the warps' sums and the widened X."""
    stage, off_bits, off_rs, off_x = pt_kernel.stage_layout(
        budget, vbytes, bk, bn, rows, xbytes)
    assert all(v % 16 == 0 for v in (stage, off_bits, off_rs, off_x))
    assert budget * vbytes + 15 <= off_bits
    assert off_bits + bk * bn // 8 + 15 <= off_rs
    assert off_rs + 4 * bk + 15 <= off_x
    assert off_x + rows * bk * xbytes <= stage < off_x + rows * bk * xbytes + 16
    plan = pt_kernel.stream_plan(1, rows, 64, 1, bk, bn, budget, vbytes,
                                 xbytes, sms=132, per_sm=_occupancy)
    assert plan.stage_bytes == stage
    assert plan.smem == (plan.stages * stage
                         + plan.threads // 32 * 16 * bn
                         + 4 * rows * bk + 16 * bk + 4 * rows * bn)
    assert plan.stages in (1, 2)
    assert plan.smem <= pt_kernel.MAX_DYN_BYTES


def test_stream_plan_refuses_what_does_not_fit():
    with pytest.raises(RuntimeError, match="fits"):
        pt_kernel.stream_plan(1, 4, 2, 2, 128, 128, 16384, 4, 2, sms=132,
                              per_sm=lambda *_: 0)
    assert [pt_kernel.row_tile(m) for m in (1, 4, 5, 8, 9, 130)] == [
        4, 4, 8, 8, 8, 8]


@pytest.mark.parametrize("case,fit,cluster", [
    ((1, 4, 12, 4, 128, 128, 12400, 4, 2), 8, 12),    # granite k_v
    ((1, 4, 12, 1, 128, 40, 3890, 4, 2), 8, 12),      # granite router
    ((1, 4, 12, 4, 128, 128, 12400, 4, 2), 3, 1),     # too few clusters fit
    ((1, 4, 64, 1, 128, 128, 8415, 4, 2), 8, 1),      # KT 64: no cluster
    ((1, 4, 16, 16, 128, 128, 8400, 4, 2), 32, 1),    # KT 16: above the cap
    ((40, 4, 12, 4, 128, 128, 12500, 4, 2), 8, 1),    # blocks walk 7 tiles
])
def test_stream_plan_clusters_one_tile_blocks(case, fit, cluster):
    """Clusters add the partials when every block walks one tile, an
    output tile's KT blocks (2 to 16) make one cluster, and the card holds
    them all at once; then no partial scratch is needed."""
    plan = pt_kernel.stream_plan(*case, sms=132, per_sm=_occupancy,
                                 clusters=lambda rows, threads, smem, size:
                                 fit)
    assert plan.cluster == cluster
    if cluster > 1:
        assert plan.blocks == plan.tiles and plan.chunk == 1
        assert plan.partial_floats == 0


@pytest.mark.parametrize("case,stages", [
    ((1, 4, 16, 64, 128, 128, 8424, 4, 2), 2),     # olmo gate/up: 2 tiles
    ((1, 4, 64, 16, 128, 128, 8398, 4, 2), 2),     # olmo down: 4 tiles
    ((40, 4, 12, 4, 128, 128, 12500, 4, 2), 1),    # granite gate/up: 8
    ((1, 4, 16, 393, 128, 128, 8429, 4, 2), 1),    # olmo head: 24
    ((1, 4, 12, 12, 128, 128, 12446, 4, 2), 1),    # granite q_o: one tile
])
def test_second_stage_only_for_short_ranges(case, stages):
    """A block walking 2 to 4 tiles loads the next during the walk; one
    walking more, or one tile, keeps a single stage; so does one whose
    second stage would cost a block per SM."""
    plan = pt_kernel.stream_plan(*case, sms=132, per_sm=_occupancy)
    assert plan.stages == stages
    fewer = pt_kernel.stream_plan(
        *case, sms=132, per_sm=lambda rows, threads, smem:
        3 if smem < 80000 else 2)
    assert fewer.stages == 1

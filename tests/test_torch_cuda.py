"""Tests of the port that need an NVIDIA card (marked ``gpu``).

The CUDA kernel has no CPU mode, so each test asks the ``cuda`` fixture
for the card and skips without one.  Nothing here imports JAX: the card's
machine runs these with ``python -m pytest -m gpu tests/test_torch_*.py``.
Tolerances are the kernels' (atol 2e-3·√K float32, 2e-2·√K bfloat16,
rtol 1e-2).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels import bitmap_spmm as kernel
from repro_torch.models.model import init_params
from repro_torch.serve import ServeEngine, poisson_trace
from repro_torch.sparse import pack_bitmap, pack_bitmap_experts

TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NONE = dict.fromkeys(LAUNCHES, 0)   # every kernel's count, none launched


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(m, k, n, sparsity, seed, groups=()):
    r = np.random.default_rng(seed)
    w = r.standard_normal((*groups, k, n)).astype(np.float32)
    w *= r.random(w.shape) >= sparsity
    return w, r.standard_normal((*groups, m, k)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,block", [(2048, 2048, (128, 128)),
                                       (256, 384, (128, 128)),
                                       (96, 48, (96, 24)),
                                       (64, 40, (64, 8))])
@pytest.mark.parametrize("m", [1, 4, 8, 130])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("vname", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda, k, n, block, m, dname, vname):
    w, x = _case(m, k, n, 0.5, seed=k + n + m)
    bw = pack_bitmap(torch.from_numpy(w).to(cuda, TYPES[vname]), block=block)
    xt = torch.from_numpy(x).to(cuda, TYPES[dname])
    reset_launches()
    out = ops.bitmap_spmm(xt, bw)
    torch.cuda.synchronize()
    assert LAUNCHES["bitmap_spmm"] == 1
    assert out.dtype == xt.dtype and out.shape == (m, n)
    expect = ops.bitmap_spmm(xt, bw, impl="torch")
    tol = 2e-2 if dname == "bfloat16" else 2e-3
    torch.testing.assert_close(out.float(), expect.float(),
                               atol=tol * np.sqrt(k), rtol=1e-2)


@pytest.mark.gpu
def test_cuda_kernel_all_zero_tiles_and_out_dtype(cuda):
    """Budget-1 packs (an all-zero weight) give zeros; out_dtype float32
    from bfloat16 X."""
    bw = pack_bitmap(torch.zeros(256, 128, device=cuda), block=(128, 128))
    assert bw.budget == 1
    x = torch.randn(3, 256, device=cuda, dtype=torch.bfloat16)
    out = ops.bitmap_spmm(x, bw, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and not out.any()


@pytest.mark.gpu
def test_cuda_kernel_rejects_bad_inputs(cuda):
    w, _ = _case(4, 128, 128, 0.5, seed=0)
    bw = pack_bitmap(torch.from_numpy(w).to(cuda), block=(128, 128))
    with pytest.raises(ValueError, match="K="):
        kernel.bitmap_spmm(torch.zeros(4, 64, device=cuda), bw)
    with pytest.raises(TypeError):
        kernel.bitmap_spmm(torch.zeros(4, 128, device=cuda,
                                       dtype=torch.float16), bw)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.bitmap_spmm(torch.zeros(128, 4, device=cuda).T, bw)


@pytest.mark.gpu
def test_engine_on_card_goes_through_kernel(cuda):
    """On the card every packed projection and the head launch the
    kernel (7 per layer + 1 per decode step), no dense rendering exists,
    and in float32 the tokens equal the CPU engine's on the same
    weights."""
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"),
                              compute_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    cpu = ServeEngine(cfg, num_slots=2, max_len=32, sparsity=0.5,
                      params=params, device="cpu")
    gpu = ServeEngine(cfg, num_slots=2, max_len=32, sparsity=0.5,
                      params=params, device=cuda)
    assert gpu.lm_weight.dense_cache is None
    assert all(bw.dense_cache is None for _, bw in gpu.packed.leaves())
    trace = poisson_trace(4, rate=0.8, seed=3, vocab_size=cfg.vocab_size,
                          max_new=(4, 8))
    a = [cpu.submit(**s) for s in trace]
    cpu.run()
    gpu.warmup()
    reset_launches()
    b = [gpu.submit(**s) for s in trace]
    gpu.run()
    assert LAUNCHES["bitmap_spmm"] == (7 * cfg.num_layers + 1) * \
        gpu.decode_steps
    assert [r.tokens for r in a] == [r.tokens for r in b]


@pytest.mark.gpu
def test_paged_decode_step_equals_contiguous_on_card(cuda):
    """olmo-1b smoke, bf16, through the kernels: a paged decode step
    (each slot's pages mapped in order, page 0 left as the trash page)
    gives the contiguous step's logits bit for bit at the same
    positions, over enough steps to fill several pages."""
    from repro_torch.models import model as M
    from repro_torch.serve.packed import pack_model
    cfg = get_smoke_config("olmo-1b")
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                         device=cuda)
    packed = pack_model(params).blocks
    b, max_len, plen = 4, 32, 8
    cont = M.init_cache(cfg, b, max_len, device=cuda)
    paged = M.init_cache(cfg, b, max_len, device=cuda, page_len=plen)
    tables = {k: torch.arange(1, b * s + 1, device=cuda).reshape(b, s)
              for k, s in M.paged_layout(cfg, max_len, plen).items()}
    g = torch.Generator(device=cuda).manual_seed(1)
    reset_launches()
    for p in range(20):
        tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                            device=cuda)
        pos = torch.tensor([p, p + 3, max(p - 2, 0), 2 * p], device=cuda)
        want, _ = M.decode_step(params, cont, cfg, tok, pos, packed=packed)
        got, _ = M.decode_step(params, paged, cfg, tok, pos, packed=packed,
                               page_tables=tables)
        assert torch.equal(want, got), p
    torch.cuda.synchronize()
    assert LAUNCHES["bitmap_spmm"] == 2 * 20 * 7 * cfg.num_layers


@pytest.mark.gpu
def test_copy_on_write_fork_on_card_keeps_the_source_page(cuda):
    """A slot writing into a page it shares with the prefix cache forks
    it first: the fork copies the page on the card, the write lands in
    the copy, and the source page's bytes are unchanged."""
    from repro_torch.models.layers import paged_kv_update
    from repro_torch.serve import PagedKVCache
    cfg = get_smoke_config("olmo-1b")
    kv = PagedKVCache(cfg, 2, 32, 8, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    prompt = list(range(1, 10))
    kv.reserve(9)
    kv.admit(0, 9, prefix=[])
    kv.ensure_range(0, 0, 8)
    for leaf in kv.cache.values():
        for t in leaf.values():
            t.normal_(generator=g)
    kv.register_prefix(0, prompt, 8)            # block 0 into the cache
    kv.retire(0)
    kv.reserve(9)
    assert kv.admit(1, 9, prefix=kv.match_prefix(prompt)[1]) == 8
    src = int(kv.pools["b0"].table[1, 0])
    before = {b: {k: t[:, src].clone() for k, t in leaf.items()}
              for b, leaf in kv.cache.items()}
    kv.ensure(1, 3)                             # a write inside block 0
    dst = int(kv.pools["b0"].table[1, 0])
    assert dst != src and kv.forks == len(kv.pools)
    line = torch.randn(1, 1, cfg.num_kv_heads, cfg.resolved_head_dim,
                       generator=g, device=cuda)
    tab = kv.tables()["b0"][1:2]
    pool = kv.cache["b0"]
    paged_kv_update(pool["k"][0], pool["v"][0], line, line, tab,
                    torch.tensor([3], device=cuda))
    torch.cuda.synchronize()
    for b, leaf in kv.cache.items():
        for k, t in leaf.items():
            assert torch.equal(t[:, src], before[b][k])
            diff = (t[:, dst] != before[b][k]).flatten(2).any(-1)
            expect = torch.zeros_like(diff)
            if b == "b0":
                expect[0, 3] = True             # period 0, line 3 only
            assert torch.equal(diff, expect), (b, k)
    kv.audit()


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(1536, 512), (512, 1536), (64, 40)])
@pytest.mark.parametrize("m", [1, 4, 64, 130])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.99])
def test_grouped_kernel_matches_plain(cuda, k, n, m, dname, sparsity):
    """granite-moe's expert shapes (40 experts) at decode and prefill M,
    one launch for all groups, against the plain version and against K1
    on each group's slice."""
    g = 40 if k > 64 else 5
    w, x = _case(m, k, n, sparsity, seed=k + n + m, groups=(g,))
    from repro_torch.serve.packed import choose_block
    bw = pack_bitmap_experts(torch.from_numpy(w[None]).to(cuda),
                             block=choose_block(k, n)).period(0)
    xt = torch.from_numpy(x).to(cuda, TYPES[dname])
    reset_launches()
    out = ops.bitmap_spmm_grouped(xt, bw)
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, "bitmap_spmm_grouped": 1}
    assert out.dtype == xt.dtype and out.shape == (g, m, n)
    expect = ops.bitmap_spmm_grouped(xt, bw, impl="torch")
    tol = 2e-2 if dname == "bfloat16" else 2e-3
    torch.testing.assert_close(out.float(), expect.float(),
                               atol=tol * np.sqrt(k), rtol=1e-2)
    for i in (0, g // 2, g - 1):
        one = ops.bitmap_spmm(xt[i], bw.period(i))
        torch.testing.assert_close(out[i].float(), one.float(),
                                   atol=tol * np.sqrt(k), rtol=1e-2)


@pytest.mark.gpu
def test_grouped_kernel_rejects_bad_inputs(cuda):
    w, _ = _case(4, 128, 64, 0.5, seed=0, groups=(1, 3))
    bw = pack_bitmap_experts(torch.from_numpy(w).to(cuda),
                             block=(128, 64)).period(0)
    with pytest.raises(ValueError, match="groups"):
        kernel.bitmap_spmm_grouped(torch.zeros(2, 4, 128, device=cuda), bw)
    with pytest.raises(ValueError, match="K="):
        kernel.bitmap_spmm_grouped(torch.zeros(3, 4, 64, device=cuda), bw)
    with pytest.raises(ValueError, match=r"\(G, M, K\)"):
        kernel.bitmap_spmm_grouped(torch.zeros(4, 128, device=cuda), bw)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.bitmap_spmm_grouped(
            torch.zeros(3, 128, 4, device=cuda).transpose(1, 2), bw)
    with pytest.raises(ValueError, match="65535"):
        kernel.bitmap_spmm_grouped(torch.zeros(3, 8 * 30000, 128,
                                               device=cuda), bw)
    with pytest.raises(TypeError):
        kernel.bitmap_spmm_grouped(torch.zeros(3, 4, 128, device=cuda,
                                               dtype=torch.float16), bw)
    with pytest.raises(ValueError, match="group-stacked"):
        kernel.bitmap_spmm_grouped(torch.zeros(1, 4, 128, device=cuda),
                                   bw.period(0))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [0, 4])
def test_moe_engine_on_card_goes_through_kernels(cuda, chunk):
    """granite-moe smoke on the card: the attention projections launch
    K1 (4 per layer; the 64×5 router has no bitmap tile and stays dense,
    as does the odd-vocabulary head), the expert stacks launch the
    grouped kernel (3 per layer), per decode step and per prefill call;
    in float32 the tokens equal the CPU engine's on the same weights."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              compute_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    kw = dict(num_slots=4, max_len=48, sparsity=0.5, params=params,
              prefill_chunk=chunk)
    cpu = ServeEngine(cfg, device="cpu", **kw)
    gpu = ServeEngine(cfg, device=cuda, **kw)
    assert all(bw.dense_cache is None for _, bw in gpu.packed.leaves())
    trace = poisson_trace(6, rate=0.8, seed=3, vocab_size=cfg.vocab_size,
                          prompt_len=(2, 12), max_new=(4, 8))
    a = [cpu.submit(**s) for s in trace]
    cpu.run()
    gpu.warmup()
    reset_launches()
    b = [gpu.submit(**s) for s in trace]
    rep = gpu.run()
    calls = gpu.decode_steps + rep["prefill"]["calls"]
    assert (chunk == 0) == (rep["prefill"]["calls"] == 0)
    assert LAUNCHES == {**NONE, "bitmap_spmm": 4 * cfg.num_layers * calls,
                        "bitmap_spmm_grouped": 3 * cfg.num_layers * calls}
    assert [r.tokens for r in a] == [r.tokens for r in b]


# K2-K4: the kernel layer's remaining entry points against their plain
# versions, at the CPU sweeps' shapes and one full-width shape each.
# Attention tolerances are the reference sweep's (atol 2e-3 float32,
# 5e-2 bfloat16: the kernel rounds p to bfloat16 before the PV product,
# the plain version does not).

def _attn_case(cuda, b, hq, hkv, sq, skv, d, dname, seed):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(
        cuda, TYPES[dname]) for s in ((b, hq, sq, d), (b, hkv, skv, d),
                                      (b, hkv, skv, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (2, 4, 4, 128, 128, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, None),
    (2, 8, 1, 128, 128, 128, True, None),
    (2, 4, 2, 256, 256, 64, True, 64),
    (2, 2, 2, 128, 128, 32, True, 16),
    (1, 8, 4, 300, 300, 256, True, 100),      # gemma3's head dim, ragged
    (1, 4, 2, 200, 130, 64, False, None),     # Sq != Skv, no mask
    (1, 2, 1, 70, 50, 32, True, 8),           # rows with no live key
    (1, 16, 16, 2048, 2048, 128, True, None),  # olmo-1b, full width
])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, sq, skv, d,
                                              causal, window, dname):
    q, k, v = _attn_case(cuda, b, hq, hkv, sq, skv, d, dname, seed=sq + d)
    reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, "flash_attention": 1}
    assert out.dtype == q.dtype and out.shape == q.shape
    expect = ops.flash_attention(q, k, v, impl="torch", causal=causal,
                                 window=window)
    atol = 5e-2 if dname == "bfloat16" else 2e-3
    torch.testing.assert_close(out.float(), expect.float(), atol=atol,
                               rtol=0)


# Rows of X for K3 / K4: decode M (1, 4, 16: 8-row tiles), wide M (17 on
# the other side of the switch; 130, 200 and 256 ragged or whole
# 128-row tiles on the tensor cores for bf16 X, 64-row tiles for float32).
ROWS = [1, 4, 16, 17, 130, 200, 256]


def _block_case(k, n, block, p_zero, seed):
    r = np.random.default_rng(seed)
    kt, nt = k // block[0], n // block[1]
    w = r.standard_normal((k, n)).astype(np.float32)
    mask = r.random((kt, nt)) >= p_zero
    return (w.reshape(kt, block[0], nt, block[1])
            * mask[:, None, :, None]).reshape(k, n)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,block,p_zero", [
    (256, 256, (128, 128), 0.5),
    (512, 128, (128, 128), 0.75),
    (256, 256, (64, 64), 0.3),
    (256, 256, (64, 64), 1.0),                # every block dropped
    (2048, 8192, (128, 128), 0.5),            # olmo-1b gate/up
])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("vname", ["float32", "bfloat16"])
@pytest.mark.parametrize("oname", [None, "float32", "bfloat16"])
def test_block_sparse_kernel_matches_plain(cuda, k, n, block, p_zero, m,
                                           dname, vname, oname):
    """Every type combination the wrapper takes: x, the packed values and
    the output each float32 or bfloat16 (``oname`` None: x's type)."""
    from repro_torch.sparse import pack_block_sparse
    w = _block_case(k, n, block, p_zero, seed=k + n + m)
    bw = pack_block_sparse(torch.from_numpy(w).to(cuda, TYPES[vname]),
                           block=block)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, k)).astype(np.float32)).to(cuda, TYPES[dname])
    out_dtype = TYPES[oname] if oname else None
    reset_launches()
    out = ops.block_sparse_matmul(x, bw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, "block_sparse_matmul": 1}
    assert out.dtype == (out_dtype or x.dtype) and out.shape == (m, n)
    expect = ops.block_sparse_matmul(x, bw, impl="torch",
                                     out_dtype=out_dtype)
    assert expect.dtype == out.dtype
    tol = 2e-2 if dname == "bfloat16" else 2e-3
    torch.testing.assert_close(out.float(), expect.float(),
                               atol=tol * np.sqrt(k), rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,nm,block", [
    (256, 128, (1, 4), (128, 128)),
    (256, 256, (2, 4), (128, 128)),
    (128, 128, (1, 4), (64, 64)),
    (256, 128, (2, 8), (64, 64)),
    (2048, 8192, (2, 4), (128, 128)),         # olmo-1b gate/up
])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("vname", ["float32", "bfloat16"])
@pytest.mark.parametrize("oname", [None, "float32", "bfloat16"])
def test_nm_kernel_matches_plain(cuda, k, n, nm, block, m, dname, vname,
                                 oname):
    """Every type combination the wrapper takes, as for block-sparse."""
    from repro_torch.kernels.nm_spmm import nm_spmm
    from repro_torch.sparse import pack_nm, prune_nm
    r = np.random.default_rng(k + n + m)
    w = prune_nm(torch.from_numpy(r.standard_normal((k, n)).astype(
        np.float32)).to(cuda, TYPES[vname]), *nm)
    nw = pack_nm(w, *nm, block=block)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(
        cuda, TYPES[dname])
    out_dtype = TYPES[oname] if oname else None
    reset_launches()
    out = nm_spmm(x, nw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, "nm_spmm": 1}
    assert out.dtype == (out_dtype or x.dtype) and out.shape == (m, n)
    expect = nm_spmm(x, nw, impl="torch", out_dtype=out_dtype)
    assert expect.dtype == out.dtype
    tol = 2e-2 if dname == "bfloat16" else 2e-3
    torch.testing.assert_close(out.float(), expect.float(),
                               atol=tol * np.sqrt(k), rtol=1e-2)
    torch.testing.assert_close(expect.float(), (x.float() @ w.to(
        x.dtype).float()).to(expect.dtype).float(), atol=tol * np.sqrt(k),
        rtol=1e-2)


def _check_product(out, expect, k, dname):
    tol = 2e-2 if dname == "bfloat16" else 2e-3
    torch.testing.assert_close(out.float(), expect.float(),
                               atol=tol * np.sqrt(k), rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["block_sparse", "nm"])
@pytest.mark.parametrize("vname", ["float32", "bfloat16"])
@pytest.mark.parametrize("oname", [None, "float32", "bfloat16"])
def test_tile_products_full_width_wide(cuda, kernel, vname, oname):
    """olmo-1b's gate/up at M = 2048 on the tensor cores (bf16 X only,
    to bound the run time)."""
    from repro_torch.kernels.nm_spmm import nm_spmm
    from repro_torch.sparse import pack_block_sparse, pack_nm, prune_nm
    k, n, m = 2048, 8192, 2048
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    out_dtype = TYPES[oname] if oname else None
    if kernel == "nm":
        w = prune_nm(torch.from_numpy(r.standard_normal((k, n)).astype(
            np.float32)).to(cuda, TYPES[vname]), 2, 4)
        bw = pack_nm(w, 2, 4, block=(128, 128))
        fn, name = nm_spmm, "nm_spmm"
    else:
        w = _block_case(k, n, (128, 128), 0.5, seed=k + n)
        bw = pack_block_sparse(torch.from_numpy(w).to(cuda, TYPES[vname]),
                               block=(128, 128))
        fn, name = ops.block_sparse_matmul, "block_sparse_matmul"
    reset_launches()
    out = fn(x, bw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, name: 1}
    assert out.dtype == (out_dtype or x.dtype) and out.shape == (m, n)
    _check_product(out, fn(x, bw, impl="torch", out_dtype=out_dtype), k,
                   "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 17, 200])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("vname", ["float32", "bfloat16"])
def test_block_sparse_empty_column_block(cuda, m, dname, vname):
    """A column block with nnzb == 0 stores exact zeros, on every path."""
    from repro_torch.sparse import pack_block_sparse
    k, n, block = 256, 384, (64, 128)
    w = _block_case(k, n, block, 0.3, seed=m)
    w[:, 128:256] = 0.0
    bw = pack_block_sparse(torch.from_numpy(w).to(cuda, TYPES[vname]),
                           block=block)
    assert int(bw.nnzb[1]) == 0 and int(bw.nnzb.sum()) > 0
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, k)).astype(np.float32)).to(cuda, TYPES[dname])
    out = ops.block_sparse_matmul(x, bw)
    torch.cuda.synchronize()
    assert not out[:, 128:256].any()
    _check_product(out, ops.block_sparse_matmul(x, bw, impl="torch"), k,
                   dname)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 16, 17, 130])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("vname", ["float32", "bfloat16"])
def test_nm_kernel_ties_and_dropped_offsets(cuda, m, dname, vname):
    """A hand-built ``NmWeight`` whose ``idx`` repeats an offset inside a
    group (the plain version adds both values) and holds offsets outside
    [0, M) (the plain version drops them), at decode and wide M."""
    from repro_torch.kernels.nm_spmm import nm_spmm
    from repro_torch.sparse import pack_nm, prune_nm
    k, n = 256, 128
    r = np.random.default_rng(m)
    w = prune_nm(torch.from_numpy(r.standard_normal((k, n)).astype(
        np.float32)), 2, 4)
    nw = pack_nm(w, 2, 4, block=(128, 128))
    idx = nw.idx.clone()                  # (KT, NT, BK / 4 * 2, BN)
    idx[:, :, 0::8, 0::3] = idx[:, :, 1::8, 0::3]   # slot 0 = slot 1: a tie
    idx[:, :, 3::8, 1::5] = 4                       # offset = M: dropped
    idx[:, :, 5::8, 2::7] = 100                     # far outside the group
    nw = dataclasses.replace(nw, values=nw.values.to(cuda, TYPES[vname]),
                             idx=idx.to(cuda))
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(
        cuda, TYPES[dname])
    reset_launches()
    out = nm_spmm(x, nw)
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, "nm_spmm": 1}
    expect = nm_spmm(x, nw, impl="torch")
    untouched = nm_spmm(x, pack_nm(w.to(cuda, TYPES[vname]), 2, 4,
                                   block=(128, 128)), impl="torch")
    assert not torch.equal(expect, untouched)   # the edits change W
    _check_product(out, expect, k, dname)


@pytest.mark.gpu
def test_tile_products_refuse_a_plan_the_path_does_not_take(cuda):
    """The entry points refuse a row tile that is not the path's and the
    tensor-core paths for float32 X, with cudaErrorInvalidValue (1)."""
    from repro_torch.kernels import block_sparse, nm_spmm
    from repro_torch.kernels.tile_product import Plan
    from repro_torch.sparse import pack_block_sparse, pack_nm, prune_nm
    w = torch.randn(256, 128, device=cuda)
    bw, nw = pack_block_sparse(w), pack_nm(prune_nm(w))
    xb = torch.randn(32, 256, device=cuda, dtype=torch.bfloat16)
    reset_launches()
    for launch, weight in ((block_sparse.block_sparse_matmul, bw),
                           (nm_spmm.nm_spmm_cuda, nw)):
        for x, p in ((xb, Plan("tensor", 64)), (xb, Plan("decode", 128)),
                     (xb, Plan("fma", 128)), (xb.float(), Plan("tensor", 128)),
                     (xb.float(), Plan("decode", 8))):
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                launch(x, weight, p=p)
    assert LAUNCHES == NONE


@pytest.mark.gpu
def test_new_kernels_reject_bad_inputs(cuda):
    """A CPU tensor, a wrong type or a mismatched shape raises; nothing
    falls back to the plain version, and nothing is counted."""
    from repro_torch.kernels import block_sparse, flash_attention, nm_spmm
    from repro_torch.sparse import pack_block_sparse, pack_nm, prune_nm
    q = torch.randn(1, 4, 64, 64, device=cuda)
    kv = torch.randn(1, 2, 64, 64, device=cuda)
    reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q.cpu(), kv.cpu(), kv.cpu())
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q[..., :48].contiguous(),
                                        kv[..., :48].contiguous(),
                                        kv[..., :48].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.flash_attention(torch.randn(1, 3, 64, 64,
                                                    device=cuda), kv, kv)
    bw = pack_block_sparse(torch.randn(256, 128, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        block_sparse.block_sparse_matmul(torch.zeros(4, 256), bw)
    with pytest.raises(TypeError):
        block_sparse.block_sparse_matmul(
            torch.zeros(4, 256, device=cuda, dtype=torch.float16), bw)
    with pytest.raises(ValueError, match="K="):
        block_sparse.block_sparse_matmul(torch.zeros(4, 128, device=cuda),
                                         bw)
    nw = pack_nm(prune_nm(torch.randn(256, 128, device=cuda)))
    with pytest.raises(ValueError, match="CUDA"):
        nm_spmm.nm_spmm_cuda(torch.zeros(4, 256), nw)
    with pytest.raises(TypeError):
        nm_spmm.nm_spmm(torch.zeros(4, 256, device=cuda,
                                    dtype=torch.float16), nw)
    with pytest.raises(ValueError, match="K="):
        nm_spmm.nm_spmm(torch.zeros(4, 128, device=cuda), nw)
    assert LAUNCHES == NONE


# K2's tensor-core path (bf16, mma.sync) against the plain version at the
# reference sweep's bf16 tolerance (atol 5e-2), over head dims, GQA
# groups, masks and lengths; and the FMA body on the same bf16 inputs.
@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (128, 128, True, None),
    (200, 200, True, 64),
    (150, 90, False, None),        # Sq != Skv, no mask
    (70, 50, True, 8),             # rows with no live key at all
    (1, 77, False, None),          # one query row
    (1, 77, True, 16),             # one row, causal: only key 0 is live
    (257, 300, False, 40),         # ragged, window without causal
])
@pytest.mark.parametrize("path", ["tensor", "fma"])
def test_flash_attention_paths_match_plain(cuda, d, group, sq, skv, causal,
                                           window, path):
    from repro_torch.kernels import flash_attention
    q, k, v = _attn_case(cuda, 1, 2 * group, 2, sq, skv, d, "bfloat16",
                         seed=sq + skv + d + group)
    reset_launches()
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window, path=path)
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, "flash_attention": 1}
    expect = ops.flash_attention(q, k, v, impl="torch", causal=causal,
                                 window=window)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), expect.float(), atol=5e-2,
                               rtol=0)


@pytest.mark.gpu
def test_flash_attention_tensor_path_refuses_float32(cuda):
    """The tensor path takes bf16 only: float32 is refused with
    cudaErrorInvalidValue (1), not run on the FMA units instead."""
    from repro_torch.kernels import flash_attention
    q = torch.randn(1, 2, 64, 64, device=cuda)
    reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        flash_attention.flash_attention(q, q, q, path="tensor")
    with pytest.raises(ValueError, match="path"):
        flash_attention.flash_attention(q, q, q, path="wgmma")
    assert LAUNCHES == NONE


# K1 and K1g (one persistent launch per call, the fold of split output
# tiles inside it) against the plain version: rows that fill 4- and 8-row
# X tiles and their ragged ends, up to 40 groups, all-zero tiles, a
# budget with budget % 4 != 0, a 0.99-sparse stack; two launches give the
# same bits.
@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 130])
@pytest.mark.parametrize("g,k,n,block", [
    (1, 2048, 2048, (128, 128)),    # K1, olmo-1b's projections
    (40, 1536, 512, (128, 128)),    # K1g, granite's gate/up stack
    (40, 512, 1536, (128, 128)),    # K1g, granite's down stack
    (3, 96, 48, (96, 24)),          # narrow tiles, generic bitmap rows
])
@pytest.mark.parametrize("case", ["holes", "odd_budget", "sparse"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_bitmap_kernels_edge_cases_match_plain(cuda, m, g, k, n, block, case,
                                               dname):
    r = np.random.default_rng(k + n + m + g)
    w = r.standard_normal((g, k, n)).astype(np.float32)
    w *= r.random(w.shape) >= (0.99 if case == "sparse" else 0.5)
    w[::2, : block[0], :] = 0.0                  # all-zero tiles
    w[1::3, :, : block[1]] = 0.0
    bw = pack_bitmap_experts(torch.from_numpy(w[None]).to(cuda),
                             block=block).period(0)
    if case == "odd_budget":   # most tiles' values start off 16 bytes
        pad = (bw.budget | 3) - bw.budget
        bw = dataclasses.replace(bw, values=torch.nn.functional.pad(
            bw.values, (0, pad)).contiguous())
        assert bw.budget % 4 == 3
    x = torch.from_numpy(r.standard_normal((g, m, k)).astype(
        np.float32)).to(cuda, TYPES[dname])
    reset_launches()
    if g == 1:
        out, again = (ops.bitmap_spmm(x[0], bw.period(0))[None]
                      for _ in range(2))
        name = "bitmap_spmm"
    else:
        out, again = (ops.bitmap_spmm_grouped(x, bw) for _ in range(2))
        name = "bitmap_spmm_grouped"
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, name: 2}
    assert torch.equal(out, again)
    expect = ops.bitmap_spmm_grouped(x, bw, impl="torch")
    tol = 2e-2 if dname == "bfloat16" else 2e-3
    torch.testing.assert_close(out.float(), expect.float(),
                               atol=tol * np.sqrt(k), rtol=1e-2)


@pytest.mark.gpu
def test_bitmap_kernel_split_output_tiles_are_folded_in_one_launch(cuda):
    """A call whose output tiles' K ranges are split between blocks (few
    column tiles, long K) folds its partials inside the one launch: the
    plan has more blocks than output tiles, two launches agree bit for
    bit, and the counters are left at zero."""
    from repro_torch.kernels import bitmap_spmm as kernel_mod
    r = np.random.default_rng(5)
    w = r.standard_normal((8192, 256)).astype(np.float32)
    w *= r.random(w.shape) >= 0.5
    bw = pack_bitmap(torch.from_numpy(w).to(cuda))
    x = torch.from_numpy(r.standard_normal((4, 8192)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    kt, nt = bw.packed_bits.shape[:2]
    plan = kernel_mod.stream_plan(
        1, 4, kt, nt, 128, 128, bw.budget, 4, 2,
        kernel_mod._build.sm_count(cuda),
        lambda rows, threads, smem: kernel_mod._per_sm(1, 0, rows, threads,
                                                       smem))
    assert plan.blocks > plan.outputs
    out, again = (ops.bitmap_spmm(x, bw) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert not kernel_mod.counters(cuda, plan.outputs)[:plan.outputs].any()
    torch.testing.assert_close(out.float(), ops.bitmap_spmm(
        x, bw, impl="torch").float(), atol=2e-2 * np.sqrt(8192), rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("sparsity", [0.5, 0.97])     # dense / sparse walk
@pytest.mark.parametrize("m", [1, 4, 130])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_bitmap_kernel_on_corrupted_bitmap_matches_plain(cuda, sparsity, m,
                                                         dname):
    """A bitflip that sets one clear bit of the last row of the last
    tile (what the engine's ``bitflip`` fault may do to a served leaf):
    every tile shares one non-zero pattern, so every tile fills the value
    budget and the extra bit's element reads slot ``budget``.  The kernel
    clamps it to the last slot as the plain version does, gives the plain
    version's output and leaves the card without an error."""
    r = np.random.default_rng(int(100 * sparsity) + m)
    k, n, bk, bn = 1024, 512, 128, 128
    mask = r.random((bk, bn)) >= sparsity
    mask[-1, -1] = False
    w = r.standard_normal((k, n)).astype(np.float32) * np.tile(
        mask, (k // bk, n // bn))
    bw = pack_bitmap(torch.from_numpy(w).to(cuda), block=(bk, bn))
    assert bw.budget == mask.sum()
    bits = bw.packed_bits.clone()
    bits[-1, -1, -1, -1] |= 0x80                 # column bn - 1
    bad = dataclasses.replace(bw, packed_bits=bits)
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)).to(
        cuda, TYPES[dname])
    reset_launches()
    out = ops.bitmap_spmm(x, bad)
    torch.cuda.synchronize()
    assert LAUNCHES == {**NONE, "bitmap_spmm": 1}
    expect = ops.bitmap_spmm(x, bad, impl="torch")
    tol = 2e-2 if dname == "bfloat16" else 2e-3
    torch.testing.assert_close(out.float(), expect.float(),
                               atol=tol * np.sqrt(k), rtol=1e-2)
    # the flipped bit changed the last output column: the plain version
    # reads the clamped slot there too
    clean = ops.bitmap_spmm(x, bw, impl="torch")
    assert not torch.equal(expect[:, -1], clean[:, -1])
    torch.testing.assert_close(expect[:, :-1], clean[:, :-1])
    torch.cuda.synchronize()

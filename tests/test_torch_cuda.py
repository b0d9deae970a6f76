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
    params = init_params(torch.Generator().manual_seed(0), cfg)
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
    assert LAUNCHES == {"bitmap_spmm": 0, "bitmap_spmm_grouped": 1}
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
    params = init_params(torch.Generator().manual_seed(0), cfg)
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
    assert LAUNCHES == {"bitmap_spmm": 4 * cfg.num_layers * calls,
                        "bitmap_spmm_grouped": 3 * cfg.num_layers * calls}
    assert [r.tokens for r in a] == [r.tokens for r in b]

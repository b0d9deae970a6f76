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


@pytest.mark.parametrize("kt,nt,m,expect", [
    (16, 16, 4, 16),     # 2048-wide output: one K tile per block
    (64, 16, 4, 33),     # K = 8192: 33 splits of 2 tiles (the kernel uses 32)
    (16, 393, 4, 2),     # the head already has 393 column tiles
    (16, 64, 130, 1),    # 17 row blocks of X fill the card without a split
    (1, 1, 1, 1),
])
def test_k_splits_fill_the_card_without_empty_splits(kt, nt, m, expect):
    splits = pt_kernel.k_splits(kt, nt, m, sms=132)
    assert splits == expect and 1 <= splits <= kt


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


@pytest.mark.parametrize("g,kt,nt,m,expect", [
    (40, 12, 4, 4, 4),      # granite gate/up at decode: 160 column tiles
    (40, 4, 12, 4, 2),      # granite down: 480 column tiles
    (40, 12, 4, 64, 1),     # prefill M = 64: 1,280 blocks already
    (1, 16, 16, 4, 16),     # one group: K1's split
])
def test_k_splits_count_the_groups(g, kt, nt, m, expect):
    assert pt_kernel.k_splits(kt, nt, m, sms=132, groups=g) == expect

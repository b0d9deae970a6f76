"""Port's block-sparse format and block_sparse_matmul (its plain version,
on the CPU) against the JAX package's pack and Pallas kernel (interpret
mode) and oracle.  Tolerances are the reference sweep's: atol 2e-3·√K
(float32), 2e-2·√K (bfloat16), rtol 1e-2."""
import dataclasses

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as ref_ref
from repro.kernels.block_sparse import block_sparse_matmul as ref_kernel
from repro.sparse import pack_block_sparse as ref_pack
from repro.sparse import unpack_block_sparse as ref_unpack
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.sparse import pack_block_sparse, unpack_block_sparse

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWEEP = [(128, 256, 256, (128, 128), 0.5),
         (128, 512, 128, (128, 128), 0.75),
         (256, 256, 256, (64, 64), 0.3)]


def _tol(dname):
    return 2e-2 if dname == "bfloat16" else 2e-3


def _case(m, k, n, block, p_zero, seed):
    """The reference sweep's construction: a seeded block mask."""
    r = np.random.default_rng(seed)
    kt, nt = k // block[0], n // block[1]
    w = r.standard_normal((k, n)).astype(np.float32)
    mask = r.random((kt, nt)) >= p_zero
    w = (w.reshape(kt, block[0], nt, block[1])
         * mask[:, None, :, None]).reshape(k, n)
    return w, r.standard_normal((m, k)).astype(np.float32)


def _both(w, x, block, dname):
    jdt, tdt = DTYPES[dname]
    return ((jnp.asarray(x, jdt), ref_pack(jnp.asarray(w, jdt), block=block)),
            (torch.from_numpy(x).to(tdt),
             pack_block_sparse(torch.from_numpy(w).to(tdt), block=block)))


def _close(a, b, k, dname):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=_tol(dname) * np.sqrt(k), rtol=1e-2)


@pytest.mark.parametrize("m,k,n,block,p_zero", SWEEP + [
    (4, 512, 256, (128, 64), 0.0), (4, 256, 128, (64, 128), 1.0)])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_pack_byte_equal_and_unpack_equal(m, k, n, block, p_zero, dname):
    w, x = _case(m, k, n, block, p_zero, seed=k + n)
    (_, rw), (_, pw) = _both(w, x, block, dname)
    for name in ("values", "kidx", "nnzb"):
        a = np.asarray(getattr(rw, name))
        b = getattr(pw, name)
        if b.dtype == torch.bfloat16:
            b = b.view(torch.int16)
            a = a.view(np.int16)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    assert (pw.shape, pw.block, pw.smax) == (rw.shape, rw.block, rw.smax)
    assert pw.hbm_bytes == rw.hbm_bytes
    assert pw.density == pytest.approx(rw.density)
    np.testing.assert_array_equal(
        np.asarray(ref_unpack(rw), np.float32),
        unpack_block_sparse(pw).float().numpy())


@pytest.mark.parametrize("m,k,n,block,p_zero", SWEEP)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_block_sparse_sweep(m, k, n, block, p_zero, dname):
    w, x = _case(m, k, n, block, p_zero, seed=hash((m, k, n, p_zero)) % 2**32)
    (rx, rw), (px, pw) = _both(w, x, block, dname)
    reset_launches()
    out = ops.block_sparse_matmul(px, pw)
    assert LAUNCHES["block_sparse_matmul"] == 0    # CPU: the plain version
    assert out.dtype == px.dtype and out.shape == (m, n)
    got = out.float().numpy()
    _close(got, ref_kernel(rx, rw, interpret=True), k, dname)
    _close(got, ref_ref.block_sparse_matmul_ref(rx, rw), k, dname)


@pytest.mark.parametrize("m", [1, 4, 130])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_block_sparse_any_rows_match_oracle(m, dname):
    """Decode and ragged M (the Pallas kernel asserts M % 128 == 0)
    against the reference's oracle, with (B, 1, K) activations."""
    k, n, block = 256, 256, (64, 64)
    w, x = _case(m, k, n, block, 0.5, seed=m)
    (rx, rw), (px, pw) = _both(w, x, block, dname)
    out = ops.block_sparse_matmul(px[:, None, :], pw)
    assert out.shape == (m, 1, n)
    _close(out[:, 0].float().numpy(),
           ref_ref.block_sparse_matmul_ref(rx, rw), k, dname)


def test_out_dtype_and_bad_impl():
    w, x = _case(2, 128, 128, (64, 64), 0.5, seed=0)
    pw = pack_block_sparse(torch.from_numpy(w))
    xb = torch.from_numpy(x).bfloat16()
    assert ops.block_sparse_matmul(xb, pw, out_dtype=torch.float32
                                   ).dtype == torch.float32
    with pytest.raises(ValueError, match="impl"):
        ops.block_sparse_matmul(xb, pw, impl="pallas")


def _refuses(exc, match, call):
    with pytest.raises(exc, match=match):
        call()


def _host_cases():
    """The host side of the tile products (``kernels/tile_product.py``):
    the path and row tile of a call, its K splits, and the wrapper's
    refusals, which come before anything is built or launched."""
    from repro_torch.kernels import block_sparse
    from repro_torch.kernels.tile_product import Plan, plan, tile_splits
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for m, wide in ((1, False), (4, False), (16, False), (17, True),
                    (130, True), (2048, True)):
        cases.append((f"plan-bf16-M{m}", lambda m=m, wide=wide: plan(
            m, bf16, 128) == (Plan("tensor", 128) if wide
                              else Plan("decode", 8))))
        cases.append((f"plan-f32-M{m}", lambda m=m, wide=wide: plan(
            m, f32, 128) == Plan("fma", 64 if wide else 8)))
    # the bf16 paths stack 128 / BK tiles per stage: BK must divide 128
    for bk in (24, 48, 96):
        cases.append((f"plan-bf16-BK{bk}", lambda bk=bk: plan(4, bf16, bk)
                      == Plan("fma", 8) and plan(64, bf16, bk)
                      == Plan("fma", 64)))
    cases.append(("plan-bf16-BK16", lambda: plan(64, bf16, 16)
                  == Plan("tensor", 128)))
    # decode M: about four blocks per SM, at most one per K step
    for m, k_steps, cols, want in ((4, 16, 64, 9), (16, 16, 64, 5),
                                   (4, 64, 16, 33), (1, 2, 64, 2)):
        cases.append((f"splits-decode-M{m}-{k_steps}x{cols}",
                      lambda m=m, k=k_steps, c=cols, want=want: tile_splits(
                          k, c, m, 132, plan(m, bf16, 128)) == want))
    # the tensor path aims at one block per SM: none at M = 2048
    cases.append(("splits-tensor-M2048", lambda: tile_splits(
        16, 16, 2048, 132, plan(2048, bf16, 128)) == 1))
    cases.append(("splits-tensor-M130", lambda: tile_splits(
        16, 64, 130, 132, plan(130, bf16, 128)) == 2))
    w = torch.from_numpy(_case(4, 256, 128, (128, 128), 0.5, seed=1)[0])
    bw = pack_block_sparse(w)
    x = torch.zeros(4, 256, dtype=bf16)
    cases.append(("refuses-cpu-tensor", lambda: _refuses(
        ValueError, "CUDA", lambda: block_sparse.block_sparse_matmul(x, bw))))
    odd = pack_block_sparse(torch.zeros(256, 96), block=(64, 48))
    cases.append(("refuses-bad-block", lambda: _refuses(
        ValueError, "BN % 32", lambda: block_sparse.block_sparse_matmul(
            x, odd))))
    cases.append(("refuses-bad-index-type", lambda: _refuses(
        TypeError, "int32", lambda: block_sparse.block_sparse_matmul(
            x, dataclasses.replace(bw, kidx=bw.kidx.long())))))
    return cases


@pytest.mark.parametrize("name,check", _host_cases(),
                         ids=[c[0] for c in _host_cases()])
def test_host_side(name, check):
    reset_launches()
    assert check() is not False, name
    assert LAUNCHES["block_sparse_matmul"] == 0

"""Port's N:M format and nm_spmm (its plain version, on the CPU) against
the JAX package's prune, pack and Pallas kernel (interpret mode).
Tolerances are the reference sweep's: atol 2e-3·√K (float32), 2e-2·√K
(bfloat16), rtol 1e-2."""
import dataclasses

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.nm_spmm import nm_spmm as ref_kernel
from repro.sparse.nm import pack_nm as ref_pack
from repro.sparse.nm import prune_nm as ref_prune
from repro.sparse.nm import unpack_nm as ref_unpack
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.nm_spmm import nm_spmm
from repro_torch.sparse import pack_nm, prune_nm, unpack_nm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("nm", [(1, 4), (2, 4), (2, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prune_nm_equal(nm, seed):
    w = np.random.default_rng(seed).standard_normal((64, 48)).astype(
        np.float32)
    np.testing.assert_array_equal(ref_prune(w, *nm),
                                  prune_nm(torch.from_numpy(w), *nm).numpy())


@pytest.mark.parametrize("nm,block", [((1, 4), (128, 128)),
                                      ((2, 4), (128, 128)),
                                      ((1, 4), (64, 64)),
                                      ((2, 8), (64, 32))])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_pack_nm_byte_equal_without_ties(nm, block, dname):
    """Random normal weights have no tied magnitudes inside a group, so
    the reference's argsort fixes one layout: values and idx byte-equal."""
    jdt, tdt = DTYPES[dname]
    w = np.random.default_rng(7).standard_normal((256, 128)).astype(
        np.float32)
    rw = ref_pack(np.asarray(jnp.asarray(w, jdt)), *nm, block=block)
    pw = pack_nm(torch.from_numpy(w).to(tdt), *nm, block=block)
    assert pw.idx.dtype == torch.int8 and pw.values.dtype == tdt
    np.testing.assert_array_equal(np.asarray(rw.idx), pw.idx.numpy())
    a = np.asarray(rw.values)
    b = pw.values.view(torch.int16).numpy() if dname == "bfloat16" else \
        pw.values.numpy()
    np.testing.assert_array_equal(a.view(b.dtype), b)
    assert (pw.shape, pw.block, pw.n_keep, pw.m_group) == (
        rw.shape, rw.block, rw.n_keep, rw.m_group)
    assert pw.hbm_bytes == rw.hbm_bytes
    assert pw.compression == pytest.approx(rw.compression)


@pytest.mark.parametrize("nm", [(1, 4), (2, 4)])
def test_pack_nm_with_ties_unpacks_equal(nm):
    """An already-pruned weight ties its zeros (and here also repeats
    magnitudes): the reference's argsort promises no order among ties, so
    the layouts may differ; the dense weight and the kept values do not."""
    r = np.random.default_rng(3)
    w = ref_prune(r.standard_normal((256, 128)).astype(np.float32), *nm)
    w[::8] = np.abs(w[::8])             # equal magnitudes across groups
    w[1::4, ::3] = -w[0::4, ::3]        # equal magnitudes inside groups
    rw = ref_pack(w, *nm, block=(128, 128))
    pw = pack_nm(torch.from_numpy(w), *nm, block=(128, 128))
    np.testing.assert_array_equal(np.asarray(ref_unpack(rw)),
                                  unpack_nm(pw).numpy())
    np.testing.assert_array_equal(np.sort(np.asarray(rw.values), axis=None),
                                  np.sort(pw.values.numpy(), axis=None))


@pytest.mark.parametrize("nm", [(1, 4), (2, 4)])
def test_unpack_nm_roundtrip(nm):
    w = prune_nm(torch.randn(256, 128, generator=torch.Generator(
        ).manual_seed(0)), *nm)
    assert torch.equal(unpack_nm(pack_nm(w, *nm, block=(64, 64))), w)


@pytest.mark.parametrize("mk,nm,block", [
    ((128, 256, 128), (1, 4), (128, 128)),
    ((128, 256, 256), (2, 4), (128, 128)),
    ((256, 128, 128), (1, 4), (64, 64)),
])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_nm_spmm_kernel_sweep(mk, nm, block, dname):
    m_rows, k, n_cols = mk
    jdt, tdt = DTYPES[dname]
    r = np.random.default_rng(hash((mk, nm)) % 2**32)
    w = ref_prune(r.standard_normal((k, n_cols)).astype(np.float32), *nm)
    x = r.standard_normal((m_rows, k)).astype(np.float32)
    rw = ref_pack(np.asarray(jnp.asarray(w, jdt)), *nm, block=block)
    pw = pack_nm(torch.from_numpy(w).to(tdt), *nm, block=block)
    reset_launches()
    out = nm_spmm(torch.from_numpy(x).to(tdt), pw)
    assert LAUNCHES["nm_spmm"] == 0     # CPU: the plain version
    assert out.dtype == tdt and out.shape == (m_rows, n_cols)
    expect = ref_kernel(jnp.asarray(x, jdt), rw, interpret=True)
    atol = (2e-2 if dname == "bfloat16" else 2e-3) * np.sqrt(k)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(expect, np.float32), atol=atol,
                               rtol=1e-2)


@pytest.mark.parametrize("m", [1, 4, 130])
def test_nm_spmm_any_rows(m):
    """Decode and ragged M (the Pallas kernel asserts M % 128 == 0), with
    (B, 1, K) activations, against a dense product of the pruned
    weight."""
    r = np.random.default_rng(m)
    w = ref_prune(r.standard_normal((256, 128)).astype(np.float32), 2, 4)
    x = r.standard_normal((m, 1, 256)).astype(np.float32)
    out = nm_spmm(torch.from_numpy(x), pack_nm(torch.from_numpy(w), 2, 4))
    assert out.shape == (m, 1, 128)
    np.testing.assert_allclose(out.numpy(), x @ w, atol=2e-3 * 16,
                               rtol=1e-2)
    with pytest.raises(ValueError, match="impl"):
        nm_spmm(torch.from_numpy(x), pack_nm(torch.from_numpy(w), 2, 4),
                impl="pallas")


def _refuses(exc, match, call):
    with pytest.raises(exc, match=match):
        call()


def _host_cases():
    """The N:M wrapper's host side: the path it takes for each M (shared
    with K3, ``tile_product.plan``), and its refusals, which come before
    anything is built or launched."""
    from repro_torch.kernels.nm_spmm import nm_spmm_cuda
    from repro_torch.kernels.tile_product import Plan, plan, tile_splits
    bf16 = torch.bfloat16
    cases = []
    for m, want in ((1, Plan("decode", 8)), (4, Plan("decode", 8)),
                    (16, Plan("decode", 8)), (17, Plan("tensor", 128)),
                    (130, Plan("tensor", 128)), (2048, Plan("tensor", 128))):
        cases.append((f"plan-2:4-block-64-M{m}",
                      lambda m=m, want=want: plan(m, bf16, 64) == want))
    # olmo-1b's w_gate 2:4 at decode M: K tiles split over ~4 blocks/SM
    for m, want in ((1, 9), (4, 9), (16, 5)):
        cases.append((f"splits-w_gate-M{m}", lambda m=m, want=want:
                      tile_splits(16, 64, m, 132, plan(m, bf16, 128))
                      == want))
    w = prune_nm(torch.randn(256, 128, generator=torch.Generator(
        ).manual_seed(0)), 2, 4)
    nw = pack_nm(w, 2, 4)
    x = torch.zeros(4, 256, dtype=bf16)
    cases.append(("refuses-cpu-tensor", lambda: _refuses(
        ValueError, "CUDA", lambda: nm_spmm_cuda(x, nw))))
    odd = pack_nm(prune_nm(torch.randn(256, 96), 2, 4), 2, 4,
                  block=(128, 48))
    cases.append(("refuses-bad-block", lambda: _refuses(
        ValueError, "BN % 32", lambda: nm_spmm_cuda(x, odd))))
    cases.append(("refuses-bad-pattern", lambda: _refuses(
        ValueError, "N <= M", lambda: nm_spmm_cuda(x, dataclasses.replace(
            nw, n_keep=5)))))
    cases.append(("refuses-idx-type", lambda: _refuses(
        TypeError, "int8", lambda: nm_spmm_cuda(x, dataclasses.replace(
            nw, idx=nw.idx.to(torch.int32))))))
    return cases


@pytest.mark.parametrize("name,check", _host_cases(),
                         ids=[c[0] for c in _host_cases()])
def test_host_side(name, check):
    reset_launches()
    assert check() is not False, name
    assert LAUNCHES["nm_spmm"] == 0

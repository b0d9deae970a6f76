"""Port's sharded bitmap layout against the JAX package's, in process:
``shard_bitmap`` / ``unshard_bitmap`` / ``shard_slice`` byte-equal, the
product over a sharded weight (the plain path and the per-shard
composition) within ``test_kernels.py``'s tolerances, ``pack_model(
shards=S)``'s manifest and stream report, and ``pack_lm_head(shards=)``.
Rank-local parts and their gather are held across ranks in
``tests/test_torch_spmd_engine.py``."""
import dataclasses

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.kernels import ops as ref_ops
from repro.kernels.bitmap_spmm import shard_slice as ref_shard_slice
from repro.serve.engine import pack_lm_head as ref_pack_lm_head
from repro.serve.packed import pack_model as ref_pack_model
from repro.sparse import format as ref_format
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pt_ref
from repro_torch.kernels.bitmap_spmm import shard_slice
from repro_torch.launch.sharding import PACKED_COL, PACKED_ROW, packed_mode
from repro_torch.models.model import init_params
from repro_torch.serve.engine import pack_lm_head
from repro_torch.serve.packed import pack_model
from repro_torch.sparse import format as pt_format
from repro_torch.sparse.pruning import global_l1_prune, tree_map

LEAVES = ("packed_bits", "values", "row_start", "dense_cache")
# (leading stack dims, pack function name)
LAYOUTS = {"2d": ((), "pack_bitmap"), "stacked": ((3,), "pack_bitmap_stacked"),
           "grouped": ((2, 3), "pack_bitmap_experts")}
K, N, BLOCK = 128, 256, (32, 32)


def _weight(lead, seed, sparsity=0.6, k=K, n=N):
    r = np.random.default_rng(seed)
    w = r.standard_normal((*lead, k, n)).astype(np.float32)
    return w * (r.random(w.shape) >= sparsity)


def _packs(layout, seed, cache_dense=False):
    lead, fn = LAYOUTS[layout]
    w = _weight(lead, seed)
    ref = getattr(ref_format, fn)(w, block=BLOCK, cache_dense=cache_dense)
    pt = getattr(pt_format, fn)(torch.from_numpy(w), block=BLOCK,
                                cache_dense=cache_dense)
    return w, ref, pt


# the reference's layout functions under one jit each: the same exact
# reshapes and moves as op by op, compiled once per shape instead of
# once per op
ref_shard_bitmap = jax.jit(ref_format.shard_bitmap, static_argnums=(1, 2))
ref_unshard_bitmap = jax.jit(ref_format.unshard_bitmap)
ref_slice = jax.jit(ref_shard_slice, static_argnums=1)


def _same(ref, pt, leaves=LEAVES):
    for name in leaves:
        a, b = getattr(ref, name), getattr(pt, name)
        if a is None:
            assert b is None, name
            continue
        a, b = np.asarray(a), b.contiguous().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.shape,
                                                           b.shape)
        assert a.tobytes() == b.tobytes(), name
    assert tuple(ref.shape) == tuple(pt.shape)
    assert tuple(ref.block) == tuple(pt.block)
    assert ref.shard == pt.shard


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["col", "row"])
@pytest.mark.parametrize("shards", [2, 4])
def test_shard_unshard_and_slices_byte_equal(layout, mode, shards):
    _, ref, pt = _packs(layout, seed=shards, cache_dense=True)
    rs = ref_shard_bitmap(ref, shards, mode)
    ps = pt_format.shard_bitmap(pt, shards, mode)
    _same(rs, ps)
    assert ps.hbm_bytes == rs.hbm_bytes == pt.hbm_bytes
    assert ps.dense_bytes == rs.dense_bytes == pt.dense_bytes
    _same(ref_unshard_bitmap(rs), pt_format.unshard_bitmap(ps))
    _same(ref, pt_format.unshard_bitmap(ps))
    for s in range(shards):
        want = ref_slice(rs, s)
        _same(want, shard_slice(ps, s))
        # a rank's part holds that slice, contiguous, under the full
        # geometry, and counts the whole weight's bytes
        part = pt_format.keep_part(ps, s)
        _same(dataclasses.replace(want, shape=ps.shape, shard=ps.shard),
              part)
        assert part.part == s and part.parts == shards
        assert all(getattr(part, n).is_contiguous() for n in LEAVES)
        assert part.resident_bytes * shards == ps.hbm_bytes
        assert part.hbm_bytes == ps.hbm_bytes
        assert part.dense_bytes == ps.dense_bytes


@pytest.mark.parametrize("mode", ["col", "row"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("m", [1, 9])
def test_sharded_product_matches_reference(mode, shards, m):
    _, ref, pt = _packs("2d", seed=10 + m)
    rs = ref_shard_bitmap(ref, shards, mode)
    ps = pt_format.shard_bitmap(pt, shards, mode)
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    want = np.asarray(ref_ops.bitmap_spmm(jnp.asarray(x), rs, impl="xla"))
    xt = torch.from_numpy(x)
    tol = dict(atol=2e-3 * np.sqrt(K), rtol=1e-2)
    # the plain path unshards; the per-shard composition runs one plain
    # product per shard slice, as the card runs one kernel launch each
    np.testing.assert_allclose(ops.bitmap_spmm(xt, ps).numpy(), want, **tol)
    per_shard = ops._sharded_spmm(xt, ps, pt_ref.bitmap_spmm_ref, None)
    np.testing.assert_allclose(per_shard.numpy(), want, **tol)


@pytest.mark.parametrize("mode", ["col", "row"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_grouped_product_matches_reference(mode, shards):
    _, ref, pt = _packs("grouped", seed=20 + shards)
    rs = ref_shard_bitmap(ref, shards, mode)
    ps = pt_format.shard_bitmap(pt, shards, mode)
    # one period of the (P, G) stack: G groups
    rs0 = ref_format.BitmapWeight(
        packed_bits=rs.packed_bits[1], values=rs.values[1],
        row_start=rs.row_start[1], shape=rs.shape, block=rs.block,
        shard=rs.shard)
    x = np.random.default_rng(shards).standard_normal(
        (3, 4, K)).astype(np.float32)
    want = np.asarray(ref_ops.bitmap_spmm_grouped(jnp.asarray(x), rs0,
                                                  impl="xla"))
    xt = torch.from_numpy(x)
    tol = dict(atol=2e-3 * np.sqrt(K), rtol=1e-2)
    np.testing.assert_allclose(
        ops.bitmap_spmm_grouped(xt, ps.period(1)).numpy(), want, **tol)
    per_shard = ops._sharded_spmm(xt, ps.period(1),
                                  pt_ref.bitmap_spmm_grouped_ref, None)
    np.testing.assert_allclose(per_shard.numpy(), want, **tol)


def test_tensor_parallel_rules_are_the_reference():
    from repro.launch import sharding as ref_sharding
    assert PACKED_COL == ref_sharding.PACKED_COL
    assert PACKED_ROW == ref_sharding.PACKED_ROW
    for comp, name in PACKED_COL | PACKED_ROW | {("moe", "router")}:
        assert packed_mode(comp, name) == ref_sharding.packed_mode(comp,
                                                                   name)


_PARAMS = {}


def _params(arch, prune=True, seed=0):
    """Seeded smoke params, pruned to 0.5 (the port's pruning, byte-equal
    to the reference's: tests/test_torch_format.py): the port's tensors
    and the same numbers as numpy for the reference, once per case."""
    key = (arch, prune, seed)
    if key not in _PARAMS:
        p = init_params(torch.Generator().manual_seed(seed), pt_smoke(arch),
                        device="cpu")
        if prune:
            p = global_l1_prune(p, 0.5)
        _PARAMS[key] = p, tree_map(lambda _, t: t.numpy(), p)
    return _PARAMS[key]


ENTRY = ("path", "packed", "reason", "block", "shard", "shard_reason",
         "sparse_bytes", "dense_bytes", "layout", "experts")


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_pack_model_shards_match_reference(arch, shards):
    pt_params, params = _params(arch)
    ref = ref_pack_model(params, shards=shards)
    pt = pack_model(pt_params, shards=shards)
    assert pt.shards == ref.shards == shards
    for a, b in zip(ref.manifest, pt.manifest, strict=True):
        for f in ENTRY:
            va, vb = getattr(a, f), getattr(b, f)
            if f == "block" and va is not None:
                va, vb = tuple(va), tuple(vb)
            assert va == vb, (a.path, f, va, vb)
    for (path, rbw), (ppath, pbw) in zip(
            [(f"{b}/{c}/{n}", w) for b, bd in ref.blocks.items()
             for c, t in bd.items() for n, w in t.items() if w is not None],
            pt.leaves(), strict=True):
        assert ppath.endswith(path)
        _same(rbw, pbw)
    for act in (None, 32):
        assert (pt.stream_report(activated_experts=act)
                == ref.stream_report(activated_experts=act))
    if shards == 3:
        # smoke widths: 3 divides no sharded dim, so every ruled tensor
        # carries a typed reason and the device bytes are the totals
        rep = pt.stream_report()
        assert rep["shard_fallbacks"] and all(
            r.startswith("shard:") and "replicated" in r
            for r in rep["shard_fallbacks"].values())
        assert (rep["device_sparse_bytes_per_step"]
                == rep["sparse_bytes_per_step"])


@pytest.mark.parametrize("shards,split", [(3, False), (4, True)])
def test_pack_lm_head_shards_match_reference(shards, split):
    cfg = ref_smoke("olmo-1b")               # vocab 256: 3 does not divide
    pt_params, params = _params("olmo-1b", prune=False, seed=1)
    ref = ref_pack_lm_head(params, cfg, sparsity=0.5, shards=shards)
    pt = pack_lm_head(pt_params, pt_smoke("olmo-1b"), sparsity=0.5,
                      shards=shards)
    assert (pt.shard == ("col", shards)) is split
    _same(ref, pt)
    assert pt.hbm_bytes == ref.hbm_bytes
    assert pt.dense_bytes == ref.dense_bytes

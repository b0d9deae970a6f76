"""Port's bitmap format and pruning against the JAX package: byte-equal
packs, identical prune masks."""
import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import init_params as ref_init_params
from repro.sparse import format as ref_format
from repro.sparse import pruning as ref_pruning
from repro_torch.bridge import params_from_numpy
from repro_torch.sparse import format as pt_format
from repro_torch.sparse import pruning as pt_pruning

BLOCKS = [((256, 256), (128, 128)), ((256, 256), (64, 128)),
          ((256, 256), (128, 64)), ((48, 96), (16, 24)), ((40, 64), (8, 8))]
SPARSITIES = [0.0, 0.5, 0.75, 0.95]


def _weight(shape, sparsity, seed):
    r = np.random.default_rng(seed)
    w = r.standard_normal(shape).astype(np.float32)
    return w * (r.random(shape) >= sparsity)


def _assert_pack_equal(ref, pt):
    for name in ("packed_bits", "values", "row_start"):
        a = np.asarray(getattr(ref, name))
        b = getattr(pt, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert ref.budget == pt.budget
    assert ref.shape == pt.shape and tuple(ref.block) == tuple(pt.block)
    assert ref.hbm_bytes == pt.hbm_bytes
    assert ref.dense_bytes == pt.dense_bytes


@pytest.mark.parametrize("shape,block", BLOCKS)
@pytest.mark.parametrize("sparsity", SPARSITIES)
def test_pack_bitmap_byte_equal(shape, block, sparsity):
    w = _weight(shape, sparsity, seed=hash((shape, block, sparsity)) % 2**32)
    ref = ref_format.pack_bitmap(w, block=block)
    pt = pt_format.pack_bitmap(torch.from_numpy(w), block=block)
    _assert_pack_equal(ref, pt)
    np.testing.assert_array_equal(np.asarray(ref_format.unpack_bitmap(ref)),
                                  pt_format.unpack_bitmap(pt).numpy())
    np.testing.assert_array_equal(pt_format.unpack_bitmap(pt).numpy(), w)


@pytest.mark.parametrize("shape,block", BLOCKS[:2] + BLOCKS[3:4])
@pytest.mark.parametrize("sparsity", SPARSITIES)
def test_pack_bitmap_stacked_byte_equal(shape, block, sparsity):
    # periods at different densities, so the shared budget is the max
    w = np.stack([_weight(shape, min(0.99, sparsity + 0.1 * i), seed=i)
                  for i in range(3)])
    ref = ref_format.pack_bitmap_stacked(w, block=block)
    pt = pt_format.pack_bitmap_stacked(torch.from_numpy(w), block=block)
    _assert_pack_equal(ref, pt)
    np.testing.assert_array_equal(
        np.asarray(ref_format.unpack_bitmap_stacked(ref)),
        pt_format.unpack_bitmap_stacked(pt).numpy())


def test_pack_bitmap_density_budget_repruning_matches():
    w = _weight((256, 256), 0.3, seed=5)
    ref = ref_format.pack_bitmap(w, block=(128, 128), density_budget=0.5)
    pt = pt_format.pack_bitmap(torch.from_numpy(w), block=(128, 128),
                               density_budget=0.5)
    _assert_pack_equal(ref, pt)


def test_pack_bitmap_dense_cache_and_bf16_values():
    w = _weight((128, 256), 0.6, seed=9)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    pt = pt_format.pack_bitmap(wb, block=(64, 128), cache_dense=True)
    assert pt.values.dtype == torch.bfloat16
    assert torch.equal(pt.dense_cache, wb)
    assert torch.equal(pt_format.unpack_bitmap(pt), wb)
    assert pt.nnz == int((w != 0).sum())


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-4b"])
@pytest.mark.parametrize("sparsity", [0.5, 0.75])
def test_global_l1_prune_identical_mask(arch, sparsity):
    cfg = ref_smoke(arch)
    ref_params = ref_init_params(jax.random.PRNGKey(3), cfg)
    np_params = jax.tree.map(np.asarray, ref_params)
    ref_pruned = jax.tree.map(np.asarray, ref_pruning.global_l1_prune(
        ref_params, sparsity))
    pt_pruned = pt_pruning.global_l1_prune(
        params_from_numpy(np_params, device="cpu"), sparsity)
    ref_items = jax.tree_util.tree_leaves_with_path(ref_pruned)
    pt_items = pt_pruning.tree_items(pt_pruned)
    assert [jax.tree_util.keystr(p) for p, _ in ref_items] == [
        pt_pruning.keystr(p) for p, _ in pt_items]
    for (path, a), (_, b) in zip(ref_items, pt_items):
        np.testing.assert_array_equal(a, b.numpy(),
                                      err_msg=jax.tree_util.keystr(path))
    assert ref_pruning.sparsity_of(ref_pruned) == pt_pruning.sparsity_of(
        pt_pruned)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.9])
def test_per_tensor_prune_identical(sparsity):
    w = np.random.default_rng(4).standard_normal((64, 256)).astype(
        np.float32)
    a = np.asarray(ref_pruning.per_tensor_prune(w, sparsity))
    b = pt_pruning.per_tensor_prune(torch.from_numpy(w), sparsity).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.75, 0.9, 1.0])
def test_quantile_matches_jnp(q):
    x = np.abs(np.random.default_rng(1).standard_normal(1001)).astype(
        np.float32)
    ref = np.asarray(jax.numpy.quantile(x, q))
    assert pt_pruning.quantile(torch.from_numpy(x), q).numpy() == ref


def test_kth_smallest_exact_with_ties_and_zeros():
    r = np.random.default_rng(2)
    x = np.abs(r.standard_normal(5000)).astype(np.float32)
    x[r.random(5000) < 0.5] = 0.0
    x[:50] = x[50]                                  # a run of ties
    xs = np.sort(x)
    t = torch.from_numpy(x)
    for k in (1, 2, 2400, 2600, 2601, 4999, 5000):
        assert pt_pruning.kth_smallest(t, k).item() == xs[k - 1]
    with pytest.raises(IndexError):
        pt_pruning.kth_smallest(t, 0)


@pytest.mark.parametrize("shape,block", [
    ((2, 5, 64, 32), (64, 32)), ((1, 8, 32, 64), (32, 64)),
    ((2, 5, 64, 32), (16, 8))])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.95])
def test_pack_bitmap_experts_byte_equal(shape, block, sparsity):
    """Expert stacks (P, E, K, N), blocks from ``choose_block`` and one
    BN = 8 case; experts at different densities so the one budget is
    the stack's largest tile count."""
    p, e, k, n = shape
    w = np.stack([_weight((e, k, n), min(0.99, sparsity + 0.02 * i), seed=i)
                  for i in range(p)])
    ref = ref_format.pack_bitmap_experts(w, block=block)
    pt = pt_format.pack_bitmap_experts(torch.from_numpy(w), block=block)
    _assert_pack_equal(ref, pt)
    assert tuple(pt.values.shape[:2]) == (p, e)
    dense = pt_format.unpack_bitmap_experts(pt).numpy()
    np.testing.assert_array_equal(
        np.asarray(ref_format.unpack_bitmap_experts(ref)), dense)
    np.testing.assert_array_equal(dense, w)
    cached = pt_format.pack_bitmap_experts(torch.from_numpy(w), block=block,
                                           cache_dense=True)
    assert torch.equal(cached.dense_cache, torch.from_numpy(w))
    one = cached.period(p - 1)          # the (E, ...) weight of a period
    assert one.values.dim() == 4 and torch.equal(one.dense_cache,
                                                 torch.from_numpy(w[-1]))


def test_pack_bitmap_stacked_in_several_passes(monkeypatch):
    """A stack larger than one packing pass packs byte-equal to one pass."""
    w = np.stack([_weight((64, 32), 0.3 + 0.1 * i, seed=i) for i in range(5)])
    whole = pt_format.pack_bitmap_stacked(torch.from_numpy(w), (32, 16))
    monkeypatch.setattr(pt_format, "_PACK_CHUNK", 2 * 64 * 32)
    pieces = pt_format.pack_bitmap_stacked(torch.from_numpy(w), (32, 16))
    _assert_pack_equal(whole, pieces)
    _assert_pack_equal(ref_format.pack_bitmap_stacked(w, block=(32, 16)),
                       pieces)


def test_global_prune_over_expert_stacks_in_pieces(monkeypatch):
    """granite-moe smoke, its leaves cut into pieces smaller than one
    leaf: the histogram and the bucket gathered piece by piece give the
    reference's mask."""
    cfg = ref_smoke("granite-moe-3b-a800m")
    np_params = jax.tree.map(np.asarray,
                             ref_init_params(jax.random.PRNGKey(3), cfg))
    ref = jax.tree.map(np.asarray, ref_pruning.global_l1_prune(
        jax.tree.map(jax.numpy.asarray, np_params), 0.5))
    monkeypatch.setattr(pt_pruning, "_PIECE", 1000)
    pt = pt_pruning.global_l1_prune(
        params_from_numpy(np_params, device="cpu"), 0.5)
    ref_items = jax.tree_util.tree_leaves_with_path(ref)
    for (path, a), (_, b) in zip(ref_items, pt_pruning.tree_items(pt)):
        np.testing.assert_array_equal(a, b.numpy(),
                                      err_msg=jax.tree_util.keystr(path))

"""Port's dense sharding rules against the JAX package's, in process.

``param_specs``, ``opt_specs`` and ``batch_specs`` depend only on the
config and the mesh's shape, so the port's spec trees are held equal,
leaf for leaf, to the reference's for every arch at full config on fake
meshes (the reference's own tests use such a mesh).  The reference's two
invariants are checked on the port's trees.  ``shard_leaf`` then
``gather_leaf`` is checked to be the identity for every spec shape by
simulating the ranks of a mesh as threads whose collectives meet at a
barrier.
"""
import math
import threading

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.launch import sharding as ref_shd
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding as shd
from repro_torch.models.model import param_shapes
from repro_torch.sparse.pruning import tree_items

MESHES = [(16, 16), (2, 4), (4, 2), (1, 1)]


def _fake_mesh(data, model):
    class FakeMesh:
        shape = {"data": data, "model": model}
        axis_names = ("data", "model")
    return FakeMesh()


def _ref_flat(specs):
    """The reference's spec tree as {key path: tuple}, in its order."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): tuple(spec) for path, spec in leaves}


def _flat(specs):
    return dict(tree_items(specs))


@pytest.mark.parametrize("data,model", MESHES)
def test_param_and_opt_specs_equal_reference(data, model):
    assert ARCHS == REF_ARCHS
    mesh = _fake_mesh(data, model)
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        for serve in (False, True):
            got = _flat(shd.param_specs(cfg, mesh, serve=serve))
            want = _ref_flat(ref_shd.param_specs(rcfg, mesh, serve=serve))
            assert list(got) == list(want), arch
            assert got == want, (arch, serve)
        got = _flat(shd.opt_specs(cfg, mesh))
        want = _ref_flat(ref_shd.opt_specs(rcfg, mesh))
        assert got == want, arch


@pytest.mark.parametrize("data,model", MESHES)
def test_batch_specs_equal_reference(data, model):
    mesh = _fake_mesh(data, model)
    for arch in ("olmo-1b", "musicgen-medium"):
        for batch in (1, 6, 8):
            got = shd.batch_specs(get_config(arch), mesh, batch)
            want = ref_shd.batch_specs(ref_config(arch), mesh, batch)
            for leaf in ("tokens", "targets", "embeds"):
                assert got(leaf) == tuple(want(leaf)), (arch, batch, leaf)


def test_specs_divide_and_shard_the_matrices():
    """The reference's invariants on the port's trees at (16, 16): every
    sharded dim divides its axis, and more than 60 % of matrix bytes
    carry ``model``."""
    mesh = _fake_mesh(16, 16)
    for arch in ARCHS:
        cfg = get_config(arch)
        specs = _flat(shd.param_specs(cfg, mesh))
        tot = sharded = 0
        for path, shape in tree_items(param_shapes(cfg)):
            spec = specs[path]
            for dim, ax in zip(shape, spec):
                if ax is not None:
                    assert dim % mesh.shape[ax] == 0, (arch, path, spec)
            if len(shape) >= 2:
                tot += math.prod(shape)
                sharded += math.prod(shape) * ("model" in spec)
        assert sharded / tot > 0.6, (arch, sharded / tot)


# ------------------------------------------- placement, ranks as threads ----


class _Group:
    """The ranks of one mesh row or column: a barrier and a slot each."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n, timeout=30)
        self.slots = [None] * n


class _RankMesh:
    """One simulated rank of a (data, model) mesh; ``group(axis)`` names
    its row or column and its index there."""
    axis_names = ("data", "model")

    def __init__(self, data, model, rank, groups):
        self.data, self.model, self.rank = data, model, rank
        self.shape = {"data": data, "model": model}
        self._groups = groups

    @property
    def data_rank(self):
        return self.rank // self.model

    @property
    def model_rank(self):
        return self.rank % self.model

    def group(self, axis):
        if axis == "model":
            return self._groups[("model", self.data_rank)], self.model_rank
        return self._groups[("data", self.model_rank)], self.data_rank


def _fake_all_gather_concat(out, local, group):
    g, i = group
    g.slots[i] = local.clone()
    g.barrier.wait()
    out.copy_(torch.cat(g.slots))
    g.barrier.wait()


SPECS = [(), (None,), ("model",), ("data",), (None, "model"),
         ("model", None), ("data", "model"), ("model", "data"),
         (None, "data", "model"), ("model", None, "data"),
         (None, None, "model")]


@pytest.mark.parametrize("data,model", [(2, 2), (4, 1), (1, 4)])
def test_shard_then_gather_is_identity(monkeypatch, data, model):
    monkeypatch.setattr(shd, "all_gather_concat", _fake_all_gather_concat)
    groups = {("model", d): _Group(model) for d in range(data)}
    groups.update({("data", m): _Group(data) for m in range(model)})
    r = np.random.default_rng(0)
    cases = []
    for spec in SPECS:
        shape = tuple(8 if i % 2 == 0 else 12 for i in range(len(spec)))
        for dtype in (torch.float32, torch.bool):
            whole = torch.from_numpy(r.standard_normal(shape)).float()
            cases.append((spec, whole > 0.3 if dtype is torch.bool
                          else whole))
    results = {}

    def rank_fn(rank):
        mesh = _RankMesh(data, model, rank, groups)
        out = []
        for spec, whole in cases:
            part = shd.shard_leaf(whole, spec, mesh)
            assert shd.whole_shape(part, spec, mesh) == tuple(whole.shape)
            out.append(shd.gather_leaf(part.clone(), spec, mesh))
        results[rank] = out

    threads = [threading.Thread(target=rank_fn, args=(k,))
               for k in range(data * model)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for rank in range(data * model):
        for (spec, whole), got in zip(cases, results[rank]):
            assert got.dtype == whole.dtype and torch.equal(got, whole), \
                (rank, spec)
    # the parts tile the whole: a dim sharded over both axes puts each
    # element on exactly one rank (``shard_leaf`` is a view)
    count = torch.zeros(8, 12, dtype=torch.int32)
    for rank in range(data * model):
        mesh = _RankMesh(data, model, rank, groups)
        shd.shard_leaf(count, ("data", "model"), mesh).add_(1)
    assert bool((count == 1).all())

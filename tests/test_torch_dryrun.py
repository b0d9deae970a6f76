"""Port's dry run (``repro_torch.launch.dryrun``) and its allocation-free
inputs against the JAX package's.

``param_structs`` / ``cache_structs`` (meta tensors) against the
reference's ``ShapeDtypeStruct`` trees for every arch; ``cache_specs``
and the param / optimizer / batch specs on the multi-pod production
mesh's shape against the reference's rules; ``launch.specs`` against the
reference's input shapes for every cell.  Then dry-run cells of olmo and
granite smoke, one rank of a 2 × 2 ``fake`` world in a subprocess (the
fake process group is global to a process): the record's keys, the
rank's stored bytes equal to the sum of its spec parts, and collectives
where the model axis is sharded.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import sharding as ref_shd
from repro.launch import specs as ref_specs
from repro.models import model as ref_M
from repro_torch.configs import ARCHS, SHAPES, cells, get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as pt_specs
from repro_torch.models.model import cache_structs, param_structs
from repro_torch.sparse.pruning import tree_items

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}]


def _fake_mesh(shape):
    class FakeMesh:
        pass
    m = FakeMesh()
    m.shape = dict(shape)
    m.axis_names = tuple(shape)
    return m


def _ref_flat(tree, leaf):
    return {tuple(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, leaf))[0]}


def _avals(tree):
    """{path: (shape, dtype name)} of a meta tree."""
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_items(tree)}


def _ref_avals(tree):
    return {p: (tuple(s.shape), str(s.dtype)) for p, s in
            _ref_flat(tree, jax.ShapeDtypeStruct).items()}


def test_param_and_cache_structs_equal_reference():
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        ps = param_structs(cfg)
        assert all(t.device.type == "meta" for _, t in tree_items(ps))
        assert _avals(ps) == _ref_avals(ref_M.param_structs(rcfg)), arch
        for kw in ({}, {"page_len": 16}):
            got = _avals(cache_structs(cfg, 4, 300, **kw))
            want = _ref_avals(ref_M.cache_structs(rcfg, 4, 300, **kw))
            assert got == want, (arch, kw)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    str(v) for v in s.values()))
def test_cache_specs_equal_reference(shape):
    mesh = _fake_mesh(shape)
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        for batch, max_len, seq in ((128, 1024, False), (1, 4096, True),
                                    (6, 512, False)):
            got = dict(tree_items(shd.cache_specs(cfg, mesh, batch, max_len,
                                                  shard_seq=seq)))
            want = {p: tuple(s) for p, s in _ref_flat(
                ref_shd.cache_specs(rcfg, mesh, batch, max_len,
                                    shard_seq=seq),
                jax.sharding.PartitionSpec).items()}
            assert got == want, (arch, batch, seq)


def test_multi_pod_param_opt_batch_specs_equal_reference():
    mesh = _fake_mesh({"pod": 2, "data": 16, "model": 16})
    ps = jax.sharding.PartitionSpec
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        for serve in (False, True):
            got = dict(tree_items(shd.param_specs(cfg, mesh, serve=serve)))
            want = {p: tuple(s) for p, s in _ref_flat(
                ref_shd.param_specs(rcfg, mesh, serve=serve), ps).items()}
            assert got == want, (arch, serve)
        got = dict(tree_items(shd.opt_specs(cfg, mesh)["m"]))
        want = {p: tuple(s) for p, s in _ref_flat(
            ref_shd.opt_specs(rcfg, mesh)["m"], ps).items()}
        assert got == want, arch
        for batch in (1, 32, 256):
            bs, rbs = (shd.batch_specs(cfg, mesh, batch),
                       ref_shd.batch_specs(rcfg, mesh, batch))
            for leaf in ("tokens", "targets", "embeds"):
                assert bs(leaf) == tuple(rbs(leaf)), (arch, batch, leaf)


def test_input_specs_equal_reference_shapes():
    """Every cell's inputs: the reference's shapes, embeds in the compute
    type, token ids int64 (what the port's steps index with)."""
    for arch, shape, _ in cells():
        cfg, rcfg = get_config(arch), ref_config(arch)
        got = _avals(pt_specs.input_specs(cfg, SHAPES[shape]))
        want = _ref_avals(ref_specs.input_specs(rcfg, REF_SHAPES[shape]))
        assert set(got) == set(want), (arch, shape)
        for p, (s, dt) in got.items():
            assert s == want[p][0], (arch, shape, p)
            assert dt == ("int64" if want[p][1] == "int32"
                          else want[p][1]), (arch, shape, p)


# ----------------------------------------------------- cells, subprocess ----

_CELLS = """
import json, sys, dataclasses, warnings
warnings.simplefilter("ignore")
import torch.distributed as dist
from repro_torch.configs import ShapeCfg, get_smoke_config
from repro_torch.launch import dryrun, sharding as shd
from repro_torch.launch.mesh import make_elastic_mesh
dryrun.fake_world(4)
mesh = make_elastic_mesh(2)
out = {"mesh": mesh.shape, "rank": mesh.rank}
shapes = [ShapeCfg("train", 32, 4, "train"), ShapeCfg("prefill", 32, 4,
          "prefill"), ShapeCfg("decode", 64, 4, "decode"),
          ShapeCfg("long", 128, 1, "decode")]
for arch in ("olmo-1b", "granite-moe-3b-a800m"):
    cfg = get_smoke_config(arch)
    for shape in shapes:
        rec = dryrun.run_cell(arch, shape.name, False, out_dir=sys.argv[1],
                              verbose=False, mesh=mesh, cfg=cfg,
                              shape=shape)
        out[arch + "/" + shape.name] = rec
print(json.dumps(out))
dist.destroy_process_group()
"""

KEYS = {"arch", "shape", "mesh", "multi_pod", "num_devices",
        "flops_per_device", "hbm_bytes_per_device", "collectives",
        "memory_analysis", "build_s", "count_s", "param_count",
        "active_param_count", "computed_on"}


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run([sys.executable, "-c", _CELLS, str(out)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1]), out


def _part_bytes(shape, spec, mesh_shape, dtype):
    """Bytes of a rank's part of a (shape, spec) leaf."""
    n = math.prod(shape)
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n //= mesh_shape[a]
    return n * dtype.itemsize


def _stored(arch, kind, cfg, shape, mesh):
    """What a rank stores for the cell's inputs, from the specs."""
    pspecs = dict(tree_items(shd.param_specs(cfg, mesh,
                                             serve=kind == "decode")))
    params = dict(tree_items(param_structs(cfg)))
    total = sum(_part_bytes(t.shape, pspecs[p], mesh.shape, t.dtype)
                for p, t in params.items())
    if kind == "train":
        ospecs = dict(tree_items(shd.opt_specs(cfg, mesh)["m"]))
        total += 2 * sum(_part_bytes(t.shape, ospecs[p], mesh.shape,
                                     torch.float32)
                         for p, t in params.items()) + 4
        total += sum(t.numel() * t.element_size() for t in
                     pt_specs.train_batch_specs(cfg, shape).values())
    elif kind == "prefill":
        bs = shd.batch_specs(cfg, mesh, shape.global_batch)
        batch = pt_specs.train_batch_specs(cfg, shape)
        batch.pop("targets")
        total += sum(_part_bytes(t.shape, bs(k), mesh.shape, t.dtype)
                     for k, t in batch.items())
    else:
        cs = dict(tree_items(shd.cache_specs(
            cfg, mesh, shape.global_batch, shape.seq_len,
            shard_seq=shape.global_batch == 1)))
        cache = dict(tree_items(cache_structs(cfg, shape.global_batch,
                                              shape.seq_len)))
        total += sum(_part_bytes(t.shape, cs[p], mesh.shape, t.dtype)
                     for p, t in cache.items())
        total += 8 + shape.global_batch * 8        # pos, tokens
    return total


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m"])
def test_dry_run_cells_on_a_fake_world(dry, arch):
    from repro_torch.configs import ShapeCfg, get_smoke_config
    recs, out_dir = dry
    assert recs["mesh"] == {"data": 2, "model": 2} and recs["rank"] == 0
    mesh = _fake_mesh(recs["mesh"])
    mesh.batch, mesh.batch_rank = 2, 0
    cfg = get_smoke_config(arch)
    shapes = {"train": ShapeCfg("train", 32, 4, "train"),
              "prefill": ShapeCfg("prefill", 32, 4, "prefill"),
              "decode": ShapeCfg("decode", 64, 4, "decode"),
              "long": ShapeCfg("long", 128, 1, "decode")}
    for name, shape in shapes.items():
        rec = recs[f"{arch}/{name}"]
        assert set(rec) == KEYS, name
        assert rec["mesh"] == "2x2" and rec["num_devices"] == 4
        assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
        mem = rec["memory_analysis"]
        assert mem["argument_bytes"] == _stored(arch, shape.kind, cfg, shape,
                                                mesh), name
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
        # the model axis is sharded: every step gathers parameters
        coll = rec["collectives"]
        assert coll["all-gather_bytes"] > 0 and coll["wire_bytes"] > 0
        if shape.kind == "train":
            # gradients all-reduced over the data axis
            assert coll["all-reduce_bytes"] > 0
        path = os.path.join(out_dir, f"{arch}__{name}__2x2.json")
        with open(path) as f:
            assert json.load(f) == rec


_PRODUCTION = """
import json
import torch.distributed as dist
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, mesh_tag
dryrun.fake_world(512)
m = make_production_mesh(multi_pod=True)
print(json.dumps({"shape": m.shape, "axes": list(m.axis_names),
                  "tag": mesh_tag(m), "size": m.size,
                  "groups": {a: m.group(a).size()
                             for a in ("data", "model", "batch")}}))
dist.destroy_process_group()
"""


def test_production_mesh_over_a_fake_world():
    """The multi-pod production mesh over a fake world of 512 ranks: the
    reference's extents and axes, its record tag, and the groups the
    steps use (the batch group is the (pod, data) plane)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    run = subprocess.run([sys.executable, "-c", _PRODUCTION], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got == {"shape": {"pod": 2, "data": 16, "model": 16},
                   "axes": ["pod", "data", "model"], "tag": "2x16x16",
                   "size": 512,
                   "groups": {"data": 16, "model": 16, "batch": 32}}

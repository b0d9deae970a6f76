"""One rank of the gloo world ``tests/test_torch_spmd_train.py`` starts.

Run as ``python tests/_torch_spmd_train_worker.py SPEC OUT`` with
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set: it
joins the world on the CPU and runs every scenario of the JSON file SPEC
with the port's sharded training (the same calls on every rank): one
train step per (arch, mesh) case, the compressed all-reduce, and
``launch.train.train`` with a checkpoint dropped and resumed.  It writes its
results to ``OUT/rank<r>.json`` and the whole (gathered) parameters to
``OUT/rank<r>.npz``.  The test module imports ``smoke_config``,
``make_batch`` and ``step_inputs`` from here for its one-rank baselines,
so both sides start alike.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import torch

OPT = dict(lr=1e-3, warmup_steps=1)


def smoke_config(arch: str):
    """The smoke config in float32; jamba's cut to two of its blocks
    (mamba + MLP, attention + MoE: every block kind), as
    ``tests/test_torch_forward.py`` cuts it, which keeps the reference's
    jit of its train step short."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    if arch == "jamba-v0.1-52b":
        cfg = dataclasses.replace(cfg, pattern=cfg.pattern[2:4],
                                  num_layers=2)
    return dataclasses.replace(cfg, compute_dtype="float32")


def make_batch(cfg, seed: int = 0) -> dict:
    """Batch 8 x 16 from a numpy seed; rows 0-1 have their first 10
    targets masked (-1) and row 5 its last 4, so that any split of the
    rows over 2 or 4 data ranks gives them different live-target
    counts."""
    r = np.random.default_rng(seed)
    targets = r.integers(0, cfg.vocab_size, (8, 16))
    targets[:2, :10] = -1
    targets[5, 12:] = -1
    return {"tokens": r.integers(0, cfg.vocab_size, (8, 16)),
            "targets": targets}


def step_inputs(arch: str, params_np: dict, prune: bool):
    """(cfg, whole params, masks or None, batch) as torch tensors, the
    same on every rank and in the one-rank baseline."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.sparse.pruning import global_l1_prune, tree_map
    cfg = smoke_config(arch)
    params = params_from_numpy(params_np, device="cpu")
    masks = None
    if prune:
        params = global_l1_prune(params, 0.5)
        masks = tree_map(lambda _, p: p != 0, params)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    return cfg, params, masks, batch


def load_numpy(path: str) -> dict:
    """A params tree saved flat (``blocks/b0/attn/wq`` keys)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def _flat_np(tree, prefix: str) -> dict:
    from repro_torch.sparse.pruning import tree_items
    return {prefix + "/".join(p): t.detach().numpy()
            for p, t in tree_items(tree)}


def step_case(case: dict, params_np: dict, arrays: dict) -> dict:
    """One sharded train step at the case's mesh (its specs and its step
    in baseline mode for a ``baseline`` case); the gathered params go
    into ``arrays``, the metrics and per-rank checks are returned."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.launch.steps import build_train_step_spmd
    from repro_torch.sparse.pruning import tree_items
    from repro_torch.train import optimizer as opt_lib
    cfg, params, masks, batch = step_inputs(case["arch"], params_np,
                                            case["prune"])
    mesh = make_elastic_mesh(case["mp"], "cpu")
    baseline = case.get("baseline", False)
    ps = shd.param_specs(cfg, mesh, baseline=baseline)
    os_ = shd.opt_specs(cfg, mesh, baseline=baseline)
    parts = shd.shard_tree(params, ps, mesh)
    opt = shd.shard_tree(opt_lib.init(params), os_, mesh)
    mparts = shd.shard_tree(masks, ps, mesh) if masks is not None else None
    step = build_train_step_spmd(cfg, opt_lib.OptConfig(**OPT), mesh,
                                 prune_masks=mparts,
                                 accum_steps=case["accum"],
                                 baseline=baseline)
    parts, opt, m = step(parts, opt, batch)
    pruned_zero = True
    if mparts is not None:
        flat_m = dict(tree_items(mparts))
        pruned_zero = all(not bool(t[~flat_m[p]].any())
                          for p, t in tree_items(parts))
    whole = shd.gather_tree(parts, ps, mesh)
    arrays.update(_flat_np(whole, case["name"] + "/"))
    flat_os = dict(tree_items(os_["m"]))
    moment = sum(t.numel() for _, t in tree_items(opt["m"]))
    moment_whole = sum(t.numel() for _, t in tree_items(params))
    moment_data = sum(t.numel() for p, t in tree_items(opt["m"])
                      if shd.sharded_on(flat_os[p], "data", mesh))
    return {"mesh": mesh.shape, "loss": float(m["loss"]),
            "tokens": float(m["tokens"]),
            "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
            "pruned_zero": pruned_zero,
            "param_resident": shd.resident_bytes(parts),
            "param_whole": shd.whole_bytes(parts, ps, mesh),
            "param_model_sharded": sum(
                t.numel() * t.element_size() for p, t in tree_items(params)
                if shd.sharded_on(dict(tree_items(ps))[p], "model", mesh)),
            "param_part_elems": sum(t.numel() for _, t in tree_items(parts)),
            "moment_elems": moment, "moment_whole_elems": moment_whole,
            "moment_data_elems": moment_data,
            "gathers": step.stats["gather"].calls,
            "all_reduces": step.stats["all_reduce"].calls}


def compression() -> dict:
    """The reference test's compressed all-reduce over 4 data ranks:
    each rank's grads and its residual row."""
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.train.compression import (compressed_psum_grads,
                                               init_error_fb)
    mesh = make_elastic_mesh(1, "cpu")

    def grad_fn(params, batch):
        return {"w": batch.mean(0) * params["w"]}

    fn = compressed_psum_grads(grad_fn, mesh, "data")
    params = {"w": torch.ones(32)}
    batch = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 32)).astype(np.float32))
    err = init_error_fb({"w": torch.zeros(32)}, mesh.data)
    grads, resid = fn(params, batch, err)
    # a second step carries the residual (error feedback)
    grads2, resid2 = fn(params, batch, resid)
    return {"mesh": mesh.shape, "grads": grads["w"].tolist(),
            "resid": resid["w"].tolist(), "grads2": grads2["w"].tolist(),
            "resid2": resid2["w"].tolist()}


def train_and_resume(out_dir: str, arrays: dict) -> dict:
    """``train(model_parallel=2, ckpt_every=2)`` for 4 steps, then the
    same run with its last checkpoint dropped, resumed from step 2."""
    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.train import train
    from repro_torch.train import checkpoint as ckpt
    kw = dict(smoke=True, steps=4, batch=8, seq=16, ckpt_every=2,
              sparsity=0.5, model_parallel=2, device="cpu")
    d = os.path.join(out_dir, "ckpt")
    whole = train("olmo-1b", ckpt_dir=d, **kw)
    dist.barrier()              # rank 0's last checkpoint is committed
    arrays.update(_flat_np(shd.gather_tree(
        whole["params"], whole["specs"], whole["mesh"]), "trained/"))
    latest = ckpt.latest_step(d)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(d, f"step_{latest}"))
    dist.barrier()
    resumed = train("olmo-1b", ckpt_dir=d, **kw)
    dist.barrier()
    arrays.update(_flat_np(shd.gather_tree(
        resumed["params"], resumed["specs"], resumed["mesh"]), "resumed/"))
    return {"mesh": whole["mesh"].shape, "latest": latest,
            "losses": whole["losses"], "resumed_losses": resumed["losses"],
            "resumed_latest": ckpt.latest_step(d), "ckpt_dir": d}


def main(spec_path: str, out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    spec = json.load(open(spec_path))
    params = {arch: load_numpy(path)
              for arch, path in spec["params"].items()}
    arrays: dict = {}
    res = {"steps": {c["name"]: step_case(c, params[c["arch"]], arrays)
                     for c in spec["cases"]}}
    res["compression"] = compression()
    res["train"] = train_and_resume(out_dir, arrays)
    rank = dist.get_rank()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])

"""Dry run: count every (arch × shape × production mesh) cell on meta
tensors, with no card and nothing allocated.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's step for 512 placeholder devices and reads XLA's cost and
memory analyses; the port runs each cell as one rank (rank 0) of a
``fake`` process group the size of the production mesh
(``launch/mesh.make_production_mesh``: 16 × 16, or 2 × 16 × 16 with
``--multi-pod``), every tensor a meta tensor:

* params by ``param_specs`` (``serve=True`` for decode cells, as the
  reference), this rank's parts; Adam moments by ``opt_specs``; inputs
  by ``launch/specs``; the decode cache by ``cache_specs``;
* the step is the port's: ``build_train_step_spmd`` (the whole batch on
  every rank, its rows taken by ``batch_specs``),
  ``build_prefill_logits_step`` on the params gathered over ``model``
  and this rank's rows, or ``build_serve_step`` on the params gathered
  over ``model`` and the cache gathered by its specs, each rank then
  keeping its block of the written cache.  Dense params, as the
  reference's dry run;
* it runs under ``launch/counters.OpCounter`` (FLOPs, bytes and
  collective bytes per rank, the reference analyzer's rules) and
  ``torch.distributed._tools.mem_tracker.MemTracker`` (the peak bytes
  this rank's tensors reach, by category).

Gather-then-compute steps hold whole gathered weights (and a decode
cell's whole cache) for the call: the peak shows it.  Every figure is
computed on meta tensors, not measured on a device.

Writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
reference's keys: ``flops_per_device``, ``hbm_bytes_per_device``,
``collectives``, ``memory_analysis`` (``argument_bytes``: the bytes
this rank stores for the call's inputs; ``peak_bytes``: MemTracker's
peak; ``temp_bytes``: the peak less the arguments; ``by_category``),
``param_count``, ``active_param_count``, ``num_devices``, ``mesh``,
``multi_pod``; the reference's ``lower_s`` / ``compile_s`` /
``analyze_s`` become ``build_s`` (specs and meta inputs) and
``count_s`` (the counted, traced call).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (SHAPES, ShapeCfg, cells, get_config,
                                 shape_supported)
from repro_torch.launch import sharding as shd
from repro_torch.counting import tensor_bytes
from repro_torch.launch.counters import OpCounter
from repro_torch.launch.mesh import make_production_mesh, mesh_tag
from repro_torch.launch.specs import decode_input_specs, train_batch_specs
from repro_torch.launch.steps import (build_prefill_logits_step,
                                      build_serve_step,
                                      build_train_step_spmd)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import param_structs
from repro_torch.sparse.pruning import tree_items, tree_map
from repro_torch.train.optimizer import OptConfig

OUT_DIR = "results/dryrun_torch"


def fake_world(size: int) -> None:
    """Make this process rank 0 of a ``fake`` world of ``size`` ranks
    (collectives return at once and move nothing); a world already made
    must have that size."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"is up; this cell needs {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _parts(tree: Dict, specs: Dict, mesh) -> Dict:
    """This rank's part of every leaf of a meta tree."""
    return shd.shard_tree(tree, specs, mesh)


def _bytes(obj) -> int:
    return sum(tensor_bytes(t) for t in _flat_tensors(obj))


def _flat_tensors(obj):
    """Every tensor of a tree of dicts, lists, tuples and dataclasses
    (``BitmapWeight``)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _flat_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _flat_tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _flat_tensors(getattr(obj, f.name))


def build_cell(arch: str, shape: ShapeCfg | str, mesh,
               cfg: Optional[ModelConfig] = None
               ) -> Tuple[Callable[[], object], Dict, ModelConfig]:
    """(call, inputs, cfg) of one cell on ``mesh``: ``call()`` runs the
    cell's step on ``inputs`` (this rank's meta parts).  ``shape``: a
    ``SHAPES`` name or a ``ShapeCfg``; ``cfg``: the arch's config unless
    given (a smoke config in the tests)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    decode = shape.kind == "decode"
    pspecs = shd.param_specs(cfg, mesh, serve=decode)
    params = _parts(param_structs(cfg), pspecs, mesh)

    if shape.kind == "train":
        ospecs = shd.opt_specs(cfg, mesh)
        f32 = tree_map(lambda _, t: torch.empty(t.shape, dtype=torch.float32,
                                                device="meta"),
                       param_structs(cfg))
        opt = {"m": _parts(f32, ospecs["m"], mesh),
               "v": _parts(f32, ospecs["v"], mesh),
               "step": torch.empty((), dtype=torch.int32, device="meta")}
        batch = train_batch_specs(cfg, shape)
        step = build_train_step_spmd(cfg, OptConfig(), mesh)
        inputs = {"params": params, "opt": opt, "batch": batch}
        return (lambda: step(params, opt, batch)), inputs, cfg

    if shape.kind == "prefill":
        bspec = shd.batch_specs(cfg, mesh, shape.global_batch)
        batch = train_batch_specs(cfg, shape)
        batch.pop("targets")
        batch = {k: shd.shard_leaf(t, bspec(k), mesh) for k, t in
                 batch.items()}
        step = build_prefill_logits_step(cfg)
        inputs = {"params": params, "batch": batch}

        def call():
            whole = shd.gather_tree(params, pspecs, mesh, axes=("model",))
            return step(whole, batch)
        return call, inputs, cfg

    specs = decode_input_specs(cfg, shape)
    ctree = shd.cache_specs(cfg, mesh, shape.global_batch, shape.seq_len,
                            shard_seq=shape.global_batch == 1)
    cspecs = dict(tree_items(ctree))
    cache = _parts(specs["cache"], ctree, mesh)
    step = build_serve_step(cfg)
    inputs = {"params": params, "cache": cache, "pos": specs["pos"],
              "tokens": specs.get("tokens"), "embeds": specs.get("embeds")}

    def call():
        # gather-then-compute: the model-sharded params and the whole
        # cache, then each rank keeps its block of the written cache
        whole = shd.gather_tree(params, pspecs, mesh, axes=("model",))
        full = shd.gather_tree(cache, ctree, mesh)
        nxt, logits, full = step(whole, full, specs.get("tokens"),
                                 specs["pos"], embeds=specs.get("embeds"))
        for (bname, key), spec in cspecs.items():
            cache[bname][key].copy_(shd.shard_leaf(full[bname][key], spec,
                                                   mesh))
        return nxt, logits
    return call, inputs, cfg


def count_cell(call: Callable[[], object], inputs: Dict
               ) -> Tuple[Dict, Dict]:
    """(counters, memory) of one call: ``OpCounter``'s result and
    MemTracker's peak over the call, the inputs tracked as stored."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    mt.track_external(*_flat_tensors(inputs))
    with mt, OpCounter(keep_ops=False) as counter:
        call()
    peak = mt.get_tracker_snapshot("peak")
    by = {}
    for per_dev in peak.values():
        for k, v in per_dev.items():
            by[k] = by.get(k, 0) + int(v)
    stored = _bytes(inputs)
    top = by.get("Total", sum(by.values()))
    return counter.result(), {"argument_bytes": stored,
                              "temp_bytes": max(top - stored, 0),
                              "peak_bytes": top, "by_category": by}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR, verbose: bool = True, mesh=None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeCfg] = None) -> dict:
    """Count one cell as rank 0 of a fake world of the production mesh's
    size; write and return its record.  ``mesh`` / ``cfg`` / ``shape``
    replace the production mesh (over the world already made), the
    arch's config and the named shape (the tests' small cells)."""
    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod)
    shape = shape or SHAPES[shape_name]
    t0 = time.perf_counter()
    call, inputs, cfg = build_cell(arch, shape, mesh, cfg)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad() if shape.kind != "train" else torch.enable_grad():
        counters, mem = count_cell(call, inputs)
    count_s = time.perf_counter() - t0
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag(mesh),
        "multi_pod": multi_pod, "num_devices": mesh.size,
        "flops_per_device": counters["flops"],
        "hbm_bytes_per_device": counters["bytes"],
        "collectives": {k: v for k, v in counters.items()
                        if k not in ("flops", "bytes")},
        "memory_analysis": mem,
        "build_s": round(build_s, 2), "count_s": round(count_s, 2),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "computed_on": "meta tensors (not measured on a device)",
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{rec['mesh']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        print(f"[OK] {arch:22s} {shape_name:12s} mesh={rec['mesh']:8s} "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"hbm/dev={rec['hbm_bytes_per_device']:.3e} "
              f"wire={counters['wire_bytes']:.3e} "
              f"stored={mem['argument_bytes']:.3e} "
              f"peak={mem['peak_bytes']:.3e} "
              f"(build {build_s:.1f}s count {count_s:.1f}s)", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single- and multi-pod meshes")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a, s, _ in cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        ok, reason = shape_supported(args.arch, args.shape)
        if not ok:
            print(f"[SKIP] {args.arch} {args.shape}: {reason}")
            return
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both else [args.multi_pod]
    failures = []
    t0 = time.perf_counter()
    # one fake world per process: the single-pod cells first, then the
    # multi-pod cells in a fresh world
    for multi_pod in meshes:
        if dist.is_initialized():
            dist.destroy_process_group()
        for arch, shape in todo:
            try:
                run_cell(arch, shape, multi_pod, out_dir=args.out)
            except Exception:
                failures.append((arch, shape, multi_pod))
                print(f"[FAIL] {arch} {shape} multi_pod={multi_pod}",
                      flush=True)
                traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print(f"dry-run complete in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()

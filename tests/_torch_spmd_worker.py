"""One rank of the gloo world ``tests/test_torch_spmd_engine.py`` starts.

Run as ``python tests/_torch_spmd_worker.py SPEC OUT`` with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set: it joins the
world on the CPU, serves every scenario of the JSON file SPEC with the
port's sharded engine (the same calls on every rank), checks
``gather_bitmap`` across the ranks, and writes its results to
``OUT/rank<r>.json``.  The test module imports ``serve`` from here for
its one-rank baselines, so both sides serve alike.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import torch

# a smoke run: every request walks a short prompt and decodes 6 tokens;
# odd requests sample (temperature 0.8, top-8), so that the comparison
# holds the seeded sampler too
PROMPTS = [[1 + (i * 7 + j) % 250 for j in range(5 + i % 4)]
           for i in range(6)]
CHAOS_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [4, 5, 6],
                 [1, 2, 3, 4, 5, 6], [9, 8, 7, 6, 5],
                 [1, 2, 3, 4, 5, 6, 7, 8], [2, 4, 6, 8]]


def prompts(cfg) -> list:
    """``PROMPTS`` within the config's vocabulary (musicgen smoke's is
    128 tokens; every other smoke vocabulary holds them as they are)."""
    return [[t % cfg.vocab_size for t in p] for p in PROMPTS]


def smoke_config(arch: str):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def load_params(path: str):
    """A params tree saved flat (``blocks/b0/attn/wq`` keys) by
    ``np.savez``, as CPU tensors."""
    from repro_torch.bridge import params_from_numpy
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_numpy(tree, device="cpu")


def engine_kwargs(sc: dict) -> dict:
    kw = dict(num_slots=sc["num_slots"], max_len=48,
              sparsity=sc["sparsity"], seed=0,
              stream_weights=sc.get("stream_weights", True))
    if sc["paged"]:
        kw.update(paged=True, page_len=8, prefix_reuse=True, preempt=True)
    if sc["prefill_chunk"]:
        kw["prefill_chunk"] = sc["prefill_chunk"]
    return kw


def serve(sc: dict, params, mp: int = 1) -> dict:
    """One scenario's run on this process's world: tokens, fallbacks,
    the shard accounting and the allocator's audit."""
    from repro_torch.serve import ServeEngine
    cfg = smoke_config(sc["arch"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # granite's head fallback
        eng = ServeEngine(cfg, params=params, device="cpu",
                          model_parallel=mp, **engine_kwargs(sc))
    for i, p in enumerate(prompts(cfg)):
        eng.submit(p, max_new_tokens=6, arrival=float(i // 2),
                   temperature=(0.8 if i % 2 else 0.0), seed=100 + i,
                   top_k=(8 if i % 2 else None))
    rep = eng.run()
    ws, tw = rep["weight_stream"], rep["traffic"]["weight"]
    if eng.page_len:
        eng.kv.audit()
    entries = [e for e in (eng.packed.manifest if eng.packed else [])
               if e.shard is not None]
    stats = (eng._step_fn.stats.report() if eng.mesh.size > 1 else {})
    resident = ({p: bw.resident_bytes for p, bw in eng.packed.leaves()}
                if eng.packed else {})
    return {**dense_accounting(eng),
        "mesh": eng.mesh.shape,
        "tokens": {str(r.rid): [int(t) for t in r.tokens]
                   for r in eng.requests},
        "greedy": [i for i in range(len(PROMPTS)) if i % 2 == 0],
        "fallbacks": {k: str(v) for k, v in rep["fallbacks"].items()},
        "shard_fallbacks": dict(ws["shard_fallbacks"]),
        "shards": int(ws["shards"]),
        "kv_shards": int(eng.kv.shards) if eng.page_len else 1,
        "dev_sparse": int(ws["device_sparse_bytes_per_step"]),
        "dev_dense": int(ws["device_dense_bytes_per_step"]),
        "tot_sparse": int(ws["sparse_bytes_per_step"]),
        "ledger_resident": tw.get("device_resident_dense_bytes"),
        "ledger": [tw["sparse_bytes_per_step"],
                   tw["device_sparse_bytes_per_step"],
                   tw["device_dense_bytes_per_step"], tw["shards"]],
        "sharded_entries": len(entries),
        "packed_dev": sum(e.sparse_bytes // e.shard[1] for e in entries),
        "packed_tot": sum(e.sparse_bytes for e in entries),
        "resident": sum(resident[e.path] for e in entries),
        "head_resident": (eng.lm_weight.resident_bytes
                          if eng.lm_weight is not None else 0),
        "head_hbm": (eng.lm_weight.hbm_bytes
                     if eng.lm_weight is not None else 0),
        "gathers": stats.get("calls", 0),
        "dense_received": stats.get("dense_bytes_received_per_call", 0),
        "report_keys": list(rep),
    }


def dense_accounting(eng) -> dict:
    """The dense params' bytes: this rank's, the whole tree's, the whole
    bytes of its model-sharded leaves, and the leaves the step gathers."""
    from repro_torch.launch.sharding import sharded_on
    from repro_torch.sparse.pruning import tree_items
    whole = sharded = 0
    for p, t in tree_items(eng.params):
        b = eng.dense_numel(p) * t.element_size()
        whole += b
        if eng.mesh.size > 1 and sharded_on(eng.param_specs[p], "model",
                                            eng.mesh):
            sharded += b
    return {"dense_resident": eng.resident_dense_bytes(),
            "dense_whole": whole, "dense_model_sharded": sharded,
            "dense_gather": sorted("/".join(p) for p in eng.dense_gather)}


QUARANTINED = "blocks/b0/mlp/w_down"


def quarantine(params, mp: int, faulted: bool) -> dict:
    """The sharded contiguous engine (mp, audited) serving ``PROMPTS``;
    ``faulted``: a bit flip in ``QUARANTINED`` (row-sharded) at step 3
    on every rank, so that it is quarantined and served from its
    gathered dense part."""
    from repro_torch.serve import FaultPlan, ServeEngine
    plan = (FaultPlan(seed=5).bitflip(step=3, tensor=QUARANTINED)
            if faulted else None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServeEngine(smoke_config("olmo-1b"), params=params,
                          device="cpu", num_slots=4, max_len=48,
                          sparsity=0.5, model_parallel=mp, seed=0,
                          audit=True, faults=plan)
        before = dense_accounting(eng)["dense_gather"]
        reqs = [eng.submit(p, 6, arrival=float(i // 2),
                           temperature=(0.8 if i % 2 else 0.0),
                           seed=100 + i, top_k=(8 if i % 2 else None))
                for i, p in enumerate(PROMPTS)]
        rep = eng.run()
    return {"tokens": {str(r.rid): [int(t) for t in r.tokens]
                       for r in reqs},
            "quarantined": sorted(rep["lifecycle"]["quarantined"]),
            "gather_before": before,
            "gather_after": dense_accounting(eng)["dense_gather"],
            "dense_received": (eng._step_fn.stats.dense_bytes_received
                               if eng.mesh.size > 1 else 0)}


def clock(params, rank: int) -> dict:
    """Deadlines and TTFT shedding in the sharded world (mp 2) with rank
    1's own clock running 1000x slow: request 2 waits in the queue past
    its 2 ms deadline, requests 4 and 5 come due at step 4 while the
    estimated TTFT is past the 1 ms budget.  Every decision reads rank
    0's clock, so every rank expires and sheds alike."""
    from repro_torch.serve import ServeEngine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServeEngine(smoke_config("olmo-1b"), params=params,
                          device="cpu", num_slots=2, max_len=48,
                          sparsity=0.5, model_parallel=2, seed=0,
                          ttft_budget_ms=1.0)
    if rank == 1:
        real = eng._clock.now
        eng._clock.now = lambda: real() / 1000.0
    reqs = [eng.submit(PROMPTS[i], 6, arrival=(4.0 if i >= 4 else 0.0),
                       deadline_ms=(2.0 if i == 2 else None))
            for i in range(6)]
    rep = eng.run()
    return {"states": {str(r.rid): r.state.name for r in reqs},
            "tokens": {str(r.rid): [int(t) for t in r.tokens]
                       for r in reqs},
            "expired": rep["lifecycle"]["expired"],
            "shed": rep["lifecycle"]["shed"], "steps": rep["steps"]}


def chaos_plans(rank: int) -> dict:
    """The sharded chaos runs' fault plans on ``rank``: none, or page
    faults on every rank and a bit flip in rank 1's part of one packed
    tensor alone, as a real bit flip lands in one device's memory."""
    from repro_torch.serve import FaultPlan
    plan = (FaultPlan(seed=11).page_squeeze(step=4, pages=6, duration=5)
            .force_preempt(step=6, count=1).evict_storm(step=9))
    return {"clean": None,
            "faulted": plan.bitflip(step=7) if rank == 1 else plan}


def chaos(params, plan) -> dict:
    """The sharded paged engine (mp 2, audited) under ``plan``."""
    from repro_torch.serve import RequestState, ServeEngine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServeEngine(smoke_config("olmo-1b"), params=params,
                          device="cpu", num_slots=8, max_len=48,
                          sparsity=0.5, model_parallel=2, seed=0,
                          paged=True, page_len=8, prefix_reuse=True,
                          preempt=True, prefill_chunk=4, audit=True,
                          faults=plan)
        reqs = [eng.submit(p, 6, arrival=float(i),
                           temperature=(0.8 if i % 2 else 0.0),
                           seed=40 + i, top_k=(8 if i % 2 else None))
                for i, p in enumerate(CHAOS_PROMPTS)]
        rep = eng.run()
    eng.kv.flush_prefix()
    eng.kv.audit()
    return {
        "kv_shards": int(eng.kv.shards),
        "tokens": {str(r.rid): [int(t) for t in r.tokens] for r in reqs},
        "done": all(r.state is RequestState.DONE and r.error is None
                    for r in reqs),
        "fired": int(rep["lifecycle"]["faults"]["fired"] if plan else 0),
        "flips": int(rep["lifecycle"]["faults"]["by_kind"].get("bitflip", 0)
                     if plan else 0),
        "leaks": sum(len(p.ref) + len(p.held)
                     for p in eng.kv.pools.values()),
        "quarantined": sorted(rep["lifecycle"]["quarantined"]),
        "fallbacks": {k: str(v) for k, v in rep["fallbacks"].items()},
    }


def indivisible(params) -> dict:
    """5 slots over a data axis of 2: the typed ``kv_shard`` fallback."""
    from repro_torch.serve import ServeEngine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServeEngine(smoke_config("olmo-1b"), params=params,
                          device="cpu", num_slots=5, max_len=32,
                          sparsity=0.5, model_parallel=2, seed=0,
                          paged=True, page_len=8)
        req = eng.submit([3, 1, 4, 1, 5], 4)
        rep = eng.run()
    return {"kv_shards": int(eng.kv.shards),
            "tokens": [int(t) for t in req.tokens],
            "fallbacks": {k: str(v) for k, v in rep["fallbacks"].items()}}


def gathers() -> list:
    """``gather_bitmap`` of each rank's part against ``unshard_bitmap``
    of the whole sharded pack: 2-D, stacked and grouped, col and row,
    over model axes of 4 and 2."""
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.sparse import format as fmt
    out = []
    for mp in (4, 2):
        mesh = make_elastic_mesh(mp)
        for lead, fn in (((), "pack_bitmap"), ((3,), "pack_bitmap_stacked"),
                         ((2, 3), "pack_bitmap_experts")):
            r = np.random.default_rng(len(lead))
            w = r.standard_normal((*lead, 64, 128)).astype(np.float32)
            w *= r.random(w.shape) >= 0.6
            bw = getattr(fmt, fn)(torch.from_numpy(w), block=(16, 16),
                                  cache_dense=True)
            for mode in ("col", "row"):
                sharded = fmt.shard_bitmap(bw, mesh.model, mode)
                part = fmt.keep_part(sharded, mesh.model_rank)
                got = fmt.gather_bitmap(part, mesh.group("model"))
                want = fmt.unshard_bitmap(sharded)
                same = got.shard is None and got.part is None and all(
                    getattr(got, n).numpy().tobytes()
                    == getattr(want, n).numpy().tobytes()
                    for n in ("packed_bits", "values", "row_start",
                              "dense_cache"))
                out.append([mp, fn, mode, bool(same)])
    return out


def main(spec_path: str, out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    spec = json.load(open(spec_path))
    params = {arch: load_params(path)
              for arch, path in spec["params"].items()}
    res = {"scenarios": {}}
    for name, sc in spec["scenarios"].items():
        res["scenarios"][name] = {
            str(mp): serve(sc, params[sc["arch"]], mp) for mp in sc["mps"]}
    res["chaos"] = {name: chaos(params["olmo-1b"], plan) for name, plan
                    in chaos_plans(dist.get_rank()).items()}
    res["indivisible"] = indivisible(params["olmo-1b"])
    res["dense_stack"] = serve(spec["dense_stack"], params["olmo-1b"], 2)
    res["quarantine"] = quarantine(params["olmo-1b"], 2, True)
    res["clock"] = clock(params["olmo-1b"], dist.get_rank())
    res["gathers"] = gathers()
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])

"""Port's sharded serving over ``torch.distributed``: one gloo world of 4
CPU ranks per module (``tests/_torch_spmd_worker.py``) serves every
scenario; the port's one-rank engine and the JAX package's one-device
engine serve the same traces here meanwhile.

The scenarios are the reference's ``test_serve_spmd.py`` four, with
``model_parallel`` cut from {1, 2, 4} over 8 devices to a world of 4
(so the data axis, and with it the KV shards, is 4 // mp), plus rwkv6
smoke and musicgen smoke (the frames frontend) at mp 2 and the
reference's sharded chaos and ``kv_shard`` runs
(``test_paging_sharded.py``).  Per scenario and mp: tokens bit-equal to
the port's one-rank engine (greedy and sampled), greedy tokens equal to
the reference engine's in float32 (not for rwkv6, whose reference engine
stops under this JAX), the same fallback keys, none blaming
``model_parallel``, ``shards == mp``, the KV shards, no shard fallbacks
at mp > 1, each rank's resident packed bytes the total floor-divided per
tensor, the device byte columns equal to the reference's sharded pack's,
and the allocator's audit clean on every rank.  The dense ``params``
are stored by ``param_specs`` too: each rank holds the whole tree less
(mp - 1)/mp of its model-sharded leaves.  Beyond the reference's: the
dense-dispatch stack at mp 2 (every sharded dense leaf gathered), a
packed leaf quarantined and served from its gathered dense part, and
deadlines and TTFT shedding with rank 1's own clock skewed, which every
rank must decide alike on rank 0's broadcast clock.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

import _torch_spmd_worker as worker
from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import init_params as ref_init_params
from repro.serve import ServeEngine as RefEngine
from repro.serve.engine import pack_lm_head as ref_pack_lm_head
from repro.serve.packed import pack_model as ref_pack_model
from repro_torch.bridge import params_from_numpy
from repro_torch.sparse.pruning import global_l1_prune, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 240
SCENARIOS = {
    "olmo-sparse-paged-prefill": dict(
        arch="olmo-1b", sparsity=0.75, paged=True, prefill_chunk=8,
        num_slots=8, mps=[1, 2, 4]),
    "olmo-dense-contig-decode": dict(
        arch="olmo-1b", sparsity=0.0, paged=False, prefill_chunk=0,
        num_slots=4, mps=[2]),
    "granite-sparse-contig-decode": dict(
        arch="granite-moe-3b-a800m", sparsity=0.75, paged=False,
        prefill_chunk=0, num_slots=4, mps=[4]),
    "granite-dense-paged-prefill": dict(
        arch="granite-moe-3b-a800m", sparsity=0.0, paged=True,
        prefill_chunk=8, num_slots=8, mps=[2]),
    "rwkv6-sparse-contig-decode": dict(
        arch="rwkv6-3b", sparsity=0.5, paged=False, prefill_chunk=0,
        num_slots=4, mps=[2]),
    # the frames frontend: every rank draws the same embeddings from the
    # same key folded with the step counter
    "musicgen-sparse-contig-decode": dict(
        arch="musicgen-medium", sparsity=0.5, paged=False,
        prefill_chunk=0, num_slots=4, mps=[2]),
}
# stream_weights=False at mp 2: every model-sharded dense leaf gathered
DENSE_STACK = dict(arch="olmo-1b", sparsity=0.5, paged=False,
                   prefill_chunk=0, num_slots=4, stream_weights=False)
# the reference ServeEngine stops on rwkv6 under this JAX
# (ShardingTypeError); its tokens are held at the decode_step level in
# tests/test_torch_ssm_engine.py
NO_REFERENCE_ENGINE = {"rwkv6-3b"}


def _ref_config(arch):
    return dataclasses.replace(ref_smoke(arch), compute_dtype="float32")


def _ref_params(arch):
    return jax.tree.map(np.asarray,
                        ref_init_params(jax.random.PRNGKey(0),
                                        _ref_config(arch)))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ref_tokens(sc):
    """The reference one-device engine's tokens for the scenario."""
    kw = worker.engine_kwargs(sc)
    cfg = _ref_config(sc["arch"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = RefEngine(cfg, **kw)
    for i, p in enumerate(worker.prompts(cfg)):
        eng.submit(p, max_new_tokens=6, arrival=float(i // 2),
                   temperature=(0.8 if i % 2 else 0.0), seed=100 + i,
                   top_k=(8 if i % 2 else None))
    eng.run()
    return {str(r.rid): [int(t) for t in r.tokens] for r in eng.requests}


_PRUNED = {}


def _ref_device_bytes(sc, params, mp):
    """The device byte columns from the reference's sharded pack and
    head, computed here (the engine prunes, then packs)."""
    cfg = _ref_config(sc["arch"])
    key = (sc["arch"], sc["sparsity"])
    if key not in _PRUNED:
        # the port's pruning, byte-equal to the reference's
        # (tests/test_torch_format.py), and quicker here
        _PRUNED[key] = (tree_map(lambda _, t: t.numpy(), global_l1_prune(
            params_from_numpy(params, device="cpu"), sc["sparsity"]))
            if sc["sparsity"] else params)
    pruned = _PRUNED[key]
    rep = ref_pack_model(pruned, shards=mp).stream_report(
        activated_experts=(sc["num_slots"] * cfg.top_k
                           if cfg.num_experts else None))
    head = ref_pack_lm_head(pruned, cfg, sc["sparsity"], shards=mp)
    head_dense = cfg.d_model * cfg.vocab_size * 4
    head_sparse = head.hbm_bytes if head is not None else head_dense
    head_sh = head.shard[1] if head is not None and head.shard else 1
    return (rep["device_sparse_bytes_per_step"] + head_sparse // head_sh,
            rep["device_dense_bytes_per_step"] + head_dense)


def _load_numpy(path):
    """A params tree saved flat by ``np.savez``, as numpy arrays."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def _all_device_bytes(paths):
    """``_ref_device_bytes`` of every scenario at each mp > 1 (mp 1
    shards nothing: its device bytes are the totals), JSON-keyed."""
    params = {a: _load_numpy(p) for a, p in paths.items()}
    return {f"{name}/{mp}": _ref_device_bytes(sc, params[sc["arch"]], mp)
            for name, sc in SCENARIOS.items() for mp in sc["mps"] if mp > 1}


# run in a process of its own beside the world: the reference's sharded
# packs' device bytes, as one JSON line
_DEVICE_BYTES = (
    "import json, sys; sys.path[:0] = sys.argv[1:3]; "
    "import test_torch_spmd_engine as t; "
    "print(json.dumps(t._all_device_bytes(json.loads(sys.argv[3]))))")


@pytest.fixture(scope="module")
def runs():
    """Start the world and the reference engines' process, serve the
    one-rank runs and pack the reference's sharded models here while they
    work, then gather every result."""
    archs = sorted({sc["arch"] for sc in SCENARIOS.values()})
    params = {a: _ref_params(a) for a in archs}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for a in archs:
            paths[a] = os.path.join(tmp, f"{a}.npz")
            np.savez(paths[a], **dict(_flat(params[a])))
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"params": paths, "scenarios": SCENARIOS,
                       "dense_stack": DENSE_STACK}, f)
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": str(WORLD), "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_spmd_worker.py"),
             spec, tmp], env={**env, "RANK": str(r)}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DEVICE_BYTES,
             os.path.join(ROOT, "tests"), os.path.join(ROOT, "src"),
             json.dumps(paths)], env={**os.environ, "OMP_NUM_THREADS": "1"},
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
        try:
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                single = {name: worker.serve(
                    sc, worker.load_params(paths[sc["arch"]]))
                    for name, sc in SCENARIOS.items()}
                olmo = worker.load_params(paths["olmo-1b"])
                single["dense_stack"] = worker.serve(DENSE_STACK, olmo)
                single["quarantine"] = worker.quarantine(olmo, 1, False)
                ref = {name: _ref_tokens(sc)
                       for name, sc in SCENARIOS.items()
                       if sc["arch"] not in NO_REFERENCE_ENGINE}
            finally:
                torch.set_num_threads(n)
            outs = [p.communicate(timeout=TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"process {r} failed:\n{err[-3000:]}"
        dev = json.loads(outs[-1][0].strip().splitlines()[-1])
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return {"ranks": ranks, "single": single, "ref": ref, "dev": dev}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_serving_matches_single_rank(runs, name):
    sc = SCENARIOS[name]
    one = runs["single"][name]
    assert one["mesh"] == {"data": 1, "model": 1} and one["shards"] == 1
    if name in runs["ref"]:
        # every request, sampled ones included: the port replays the
        # reference's sampling keys
        ref = runs["ref"][name]
        assert one["greedy"]
        for i in range(len(one["tokens"])):
            assert one["tokens"][str(i)] == ref[str(i)], (name, i)
    for rank, res in enumerate(runs["ranks"]):
        for mp in sc["mps"]:
            r = res["scenarios"][name][str(mp)]
            ctx = f"{name} mp={mp} rank {rank}"
            assert r["mesh"] == {"data": WORLD // mp, "model": mp}, ctx
            # the whole point: the same tokens as one rank, sampled ones
            # included
            assert r["tokens"] == one["tokens"], ctx
            assert r["report_keys"] == one["report_keys"], ctx
            assert set(r["fallbacks"]) == set(one["fallbacks"]), ctx
            for reason in r["fallbacks"].values():
                assert "model_parallel" not in reason, (ctx, reason)
            assert r["shards"] == mp, ctx
            if sc["paged"]:
                assert r["kv_shards"] == WORLD // mp, ctx
            assert r["gathers"] > 0, ctx
            # the traffic ledger's columns are the engine's
            assert r["ledger"][:3] == [r["tot_sparse"], r["dev_sparse"],
                                       r["dev_dense"]], ctx
            assert r["ledger"][3] == mp, ctx
            if mp > 1:
                assert [r["dev_sparse"], r["dev_dense"]] == \
                    runs["dev"][f"{name}/{mp}"], ctx
                assert r["shard_fallbacks"] == {}, ctx
                assert r["sharded_entries"] > 0, ctx
                # each rank holds exactly its floor-divided share
                assert r["resident"] == r["packed_dev"], ctx
                assert r["packed_dev"] * mp == r["packed_tot"], ctx
                assert r["dev_sparse"] < r["tot_sparse"], ctx
                if r["head_hbm"] and sc["arch"] != "granite-moe-3b-a800m":
                    assert r["head_resident"] * mp == r["head_hbm"], ctx
                # the dense params by param_specs: each rank holds the
                # whole tree less (mp - 1)/mp of its model-sharded leaves
                assert r["dense_model_sharded"] > 0, ctx
                assert r["dense_resident"] == (
                    r["dense_whole"]
                    - r["dense_model_sharded"] * (mp - 1) // mp), ctx
                assert r["dense_whole"] == one["dense_whole"], ctx
                # the ledger's per-rank resident column, beside the
                # packed ones (a sharded world only)
                assert r["ledger_resident"] == r["dense_resident"], ctx
                assert one["ledger_resident"] is None
                # every leaf has a packed form: no dense leaf travels
                assert r["dense_gather"] == [] and r["dense_received"] == 0
            else:
                assert r["dev_sparse"] == r["tot_sparse"], ctx
                assert r["dense_resident"] == r["dense_whole"], ctx
                assert r["resident"] == 0 and r["sharded_entries"] == 0


def test_chaos_on_sharded_engine_matches_clean_run(runs):
    for rank, res in enumerate(runs["ranks"]):
        clean, chaos = res["chaos"]["clean"], res["chaos"]["faulted"]
        assert clean["kv_shards"] == WORLD // 2, rank
        # page faults on every rank, the bit flip on rank 1 alone
        assert chaos["fired"] == 3 + (rank == 1), (rank, "a fault missed")
        # every rank quarantines the flipped tensor and serves it dense,
        # as one rank would
        assert len(chaos["quarantined"]) == 1 and not clean["quarantined"]
        assert chaos["quarantined"] == runs["ranks"][0]["chaos"][
            "faulted"]["quarantined"], rank
        assert chaos["tokens"] == clean["tokens"], rank
        assert chaos["tokens"] == runs["ranks"][0]["chaos"]["faulted"][
            "tokens"], rank
        assert chaos["done"] and clean["done"], rank
        assert chaos["leaks"] == 0 and clean["leaks"] == 0, rank


def test_bit_flip_in_one_rank_part_quarantines_on_every_rank(runs):
    """The chaos run's bit flip lands in rank 1's part alone: the ranks
    agree on the integrity verdict, so every rank quarantines the same
    tensor, replays alike and serves the clean run's tokens."""
    flipped = runs["ranks"][1]["chaos"]["faulted"]
    assert len(flipped["quarantined"]) == 1, flipped
    for rank, res in enumerate(runs["ranks"]):
        clean, chaos = res["chaos"]["clean"], res["chaos"]["faulted"]
        assert chaos["flips"] == (1 if rank == 1 else 0), rank
        assert chaos["quarantined"] == flipped["quarantined"], rank
        assert set(chaos["fallbacks"]) == set(flipped["fallbacks"]), rank
        assert chaos["tokens"] == clean["tokens"], rank


def test_dense_stack_gathers_every_sharded_leaf(runs):
    """stream_weights=False at mp 2: the step reads every block matrix
    densely, so every model-sharded block leaf is gathered, and the
    tokens are the one-rank dense-dispatch engine's."""
    one = runs["single"]["dense_stack"]
    for rank, res in enumerate(runs["ranks"]):
        r = res["dense_stack"]
        assert r["mesh"] == {"data": 2, "model": 2}, rank
        assert r["tokens"] == one["tokens"], rank
        assert r["gathers"] > 0, rank
        sharded_blocks = r["dense_gather"]
        assert sharded_blocks and all(p.startswith("blocks/")
                                      for p in sharded_blocks), rank
        assert len(sharded_blocks) == 7           # wq wk wv wo, the MLP
        assert r["dense_received"] == r["dense_model_sharded"] // 2, rank
        assert r["dense_resident"] == (r["dense_whole"]
                                       - r["dense_model_sharded"] // 2)
        # the ledger counts whole tensors, as the reference's
        assert r["tot_sparse"] == one["tot_sparse"], rank


def test_quarantined_leaf_is_served_from_its_gathered_dense_part(runs):
    """A bit flip in a row-sharded packed leaf on every rank: the leaf is
    quarantined, the step gathers its dense part from then on, and every
    request replays to the clean one-rank run's tokens."""
    clean = runs["single"]["quarantine"]
    assert clean["quarantined"] == [] and clean["gather_after"] == []
    for rank, res in enumerate(runs["ranks"]):
        q = res["quarantine"]
        assert q["quarantined"] == [worker.QUARANTINED], rank
        assert q["gather_before"] == [], rank
        assert q["gather_after"] == [worker.QUARANTINED], rank
        assert q["dense_received"] > 0, rank
        assert q["tokens"] == clean["tokens"], rank


def test_world_clock_expires_and_sheds_alike_on_every_rank(runs):
    """Rank 1's own clock runs 1000x slow; the decisions read rank 0's,
    broadcast once per step, so every rank expires and sheds the same
    requests and serves the same tokens."""
    c0 = runs["ranks"][0]["clock"]
    assert c0["states"]["2"] == "EXPIRED", c0
    assert c0["states"]["4"] == c0["states"]["5"] == "SHED", c0
    assert c0["states"]["0"] == c0["states"]["1"] == "DONE", c0
    assert c0["expired"] >= 1 and c0["shed"] >= 2, c0
    for rank, res in enumerate(runs["ranks"]):
        assert res["clock"] == c0, rank


def test_kv_shard_fallback_is_typed_and_serving_continues(runs):
    for rank, res in enumerate(runs["ranks"]):
        indiv = res["indivisible"]
        assert indiv["kv_shards"] == 1, rank           # degraded, served
        assert len(indiv["tokens"]) == 4, rank
        reason = indiv["fallbacks"]["kv_shard"]
        assert reason == ("shard: kv_shards=2 must equal the mesh data "
                          "axis (2) and divide num_slots=5; page pools "
                          "stored replicated"), reason
        for run in (res["chaos"]["clean"], res["chaos"]["faulted"], indiv):
            for why in run["fallbacks"].values():
                assert "model_parallel" not in why, why


def test_gather_bitmap_is_unshard_across_ranks(runs):
    for rank, res in enumerate(runs["ranks"]):
        cases = res["gathers"]
        assert len(cases) == 12, rank
        assert all(same for *_, same in cases), (rank, cases)


def test_world_of_one_refuses_to_shard():
    """A world of one rank asked for ``model_parallel`` 2 (or paged
    ``kv_shards`` 2) builds the clamped (1, 1) mesh, as the reference's
    ``make_elastic_mesh`` does on one device, and serves the unsharded
    engine's tokens, sampled ones included."""
    from repro_torch.serve import ServeEngine
    cfg = worker.smoke_config("olmo-1b")

    def tokens(**kw):
        eng = ServeEngine(cfg, device="cpu", num_slots=2, max_len=32,
                          sparsity=0.5, seed=0, **kw)
        for i, p in enumerate(worker.prompts(cfg)[:3]):
            eng.submit(p, max_new_tokens=4, arrival=float(i),
                       temperature=(0.8 if i % 2 else 0.0), seed=100 + i)
        eng.run()
        assert eng.mesh.size == 1 and eng.model_parallel == 1
        assert eng.packed.shards == 1
        return [list(r.tokens) for r in eng.requests]

    assert tokens(model_parallel=2) == tokens()
    paged = dict(paged=True, page_len=8)
    assert tokens(kv_shards=2, **paged) == tokens(**paged)
    # what the reference's engine does on one device: the same clamp,
    # the pools unsharded, no fallback recorded
    rcfg = _ref_config("olmo-1b")
    for kw in (dict(model_parallel=2), dict(kv_shards=2, **paged)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = RefEngine(rcfg, num_slots=2, max_len=32, **kw)
            pt = ServeEngine(cfg, device="cpu", num_slots=2, max_len=32,
                             **kw)
        assert ref.model_parallel == pt.model_parallel == 1
        assert dict(ref.mesh.shape) == pt.mesh.shape
        assert ref.kv_shard_fallback is pt.kv_shard_fallback is None
        assert ref.fallbacks == pt.fallbacks
        if kw.get("paged"):
            assert ref.kv.shards == pt.kv.shards == 1


def test_cli_serves_sharded_under_torchrun(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.serve", "--arch", "olmo-1b", "--smoke",
         "--sparsity", "0.5", "--requests", "4", "--model-parallel", "2",
         "--dist-backend", "gloo", "--device", "cpu",
         "--metrics-out", str(tmp_path / "metrics.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    # rank 0 alone prints and writes
    assert out.stdout.count("sharded: mesh {'data': 1, 'model': 2} over "
                            "gloo | packed shards 2") == 1, out.stdout
    assert out.stdout.count("4 requests / ") == 1, out.stdout
    assert json.loads((tmp_path / "metrics.json").read_text())


def test_nccl_with_more_ranks_than_cards_names_gloo(monkeypatch, capsys):
    """``init_world`` never switches backend or device by itself: NCCL
    on a host with fewer cards than ranks raises and names gloo; the CLI
    in a world of one rank serves alone on the clamped mesh."""
    from repro_torch.launch import serve as cli
    from repro_torch.launch.mesh import init_world
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        init_world("nccl", "cuda")
    with pytest.raises(ValueError, match="backend"):
        init_world("mpi", "cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    cli.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
              "--model-parallel", "2", "--requests", "2"])
    assert "2 requests / " in capsys.readouterr().out

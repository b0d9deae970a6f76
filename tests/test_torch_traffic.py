"""Port's traffic ledger against the JAX package's: the role map, the
per-role bytes (equal to the reference's and summing to ``weight_stream``
to the byte), the phase counters after one trace, the 28 nm energy
projection, the modeled executed bytes, the H100 roofline, and the
cross-check that records why it has no compiled program to count.
"""
import dataclasses
import json
import math
import warnings

import numpy as np
import pytest

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as ref_M
from repro.serve import ServeEngine as RefEngine
from repro.serve.traffic import role_of as ref_role_of
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.launch.roofline import (BF16_FLOPS_PER_S, HBM_BYTES_PER_S,
                                         roofline)
from repro_torch.serve import ServeEngine as PtEngine
from repro_torch.serve import load_trace, poisson_trace, role_of
from repro_torch.serve.traffic import (NO_HLO, TRAFFIC_KINDS,
                                       TRAFFIC_PHASES)

ARCHS = ["olmo-1b", "granite-moe-3b-a800m"]
KNOBS = {"packed": dict(),
         "dense": dict(stream_weights=False, bitmap_head=False),
         "packed-paged-prefill": dict(paged=True, page_len=8,
                                      prefill_chunk=8, prefix_reuse=True)}


def _engines(arch, **kw):
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype="float32")
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype="float32")
    params = jax.tree.map(np.asarray,
                          ref_M.init_params(jax.random.PRNGKey(0), cfg))
    kw = {"num_slots": 2, "max_len": 32, "sparsity": 0.5, "seed": 0, **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # fallback warnings
        ref = RefEngine(cfg, **kw)
        pt = PtEngine(pcfg, params=params_from_numpy(params, device="cpu"),
                      device="cpu", **kw)
    # the same values as host arrays, without the mesh's NamedSharding:
    # this JAX's sharding-in-types cannot resolve the dense-dispatch KV
    # scatter's output sharding on one CPU
    ref.params = jax.tree.map(np.asarray, ref.params)
    return ref, pt


def _run(eng, requests=4):
    trace = poisson_trace(requests, rate=0.5, seed=0,
                          vocab_size=eng.cfg.vocab_size, prompt_len=(1, 12),
                          max_new=(2, 5))
    for spec in trace:
        eng.submit(**spec)
    rep = eng.run()
    return rep, [list(r.tokens) for r in eng.requests]


def test_role_of_equals_reference():
    paths = ["blocks/b0/attn/wq", "blocks/b0/attn/wk", "blocks/b0/attn/wv",
             "blocks/b0/attn/wo", "blocks/b0/attn/norm", "blocks/b1/attn/q_norm",
             "blocks/b0/mlp/w_up", "blocks/b0/mlp/norm", "blocks/b0/moe/router",
             "blocks/b0/moe/w_gate", "blocks/b0/moe/w_down",
             "blocks/b0/moe/shared", "blocks/b0/mamba/in_proj",
             "blocks/b0/rwkv/wk", "blocks/b0/rwkv_cm/cm_k",
             "blocks/b2/conv/w"]
    assert [role_of(p) for p in paths] == [ref_role_of(p) for p in paths]
    assert role_of("blocks/b0/attn/wq") == "attn.wq"
    assert role_of("blocks/b0/moe/w_gate") == "moe.experts"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("knobs", list(KNOBS))
def test_ledger_equals_reference_and_weight_stream(arch, knobs):
    """Per-role bytes equal the reference's and sum to the engine's
    ``weight_stream`` to the byte; after one trace the phase counters,
    the KV accounting and the energy projection equal the reference's
    too."""
    ref, pt = _engines(arch, **KNOBS[knobs])
    assert pt.traffic.per_role() == ref.traffic.per_role()
    ref_rep, ref_toks = _run(ref)
    rep, toks = _run(pt)
    assert toks == ref_toks
    ws, roles = rep["weight_stream"], rep["traffic"]["per_role"]
    assert sum(r["sparse_bytes"] for r in roles.values()) \
        == ws["sparse_bytes_per_step"]
    assert sum(r["dense_bytes"] for r in roles.values()) \
        == ws["dense_bytes_per_step"]
    tr, ref_tr = rep["traffic"], ref_rep["traffic"]
    for key in ("per_role", "weight", "kv", "phases", "energy"):
        assert tr[key] == ref_tr[key], key
    assert tr["phases"]["decode"]["steps"] > 0
    assert list(tr["roofline"]) == list(ref_tr["roofline"])
    if pt.cfg.num_experts:
        assert "moe.experts" in roles and "moe.router" in roles
    assert "head" in roles


@pytest.mark.parametrize("knobs", ["packed", "dense", "packed-paged-prefill"])
def test_modeled_executed_equals_reference(knobs):
    ref, pt = _engines("olmo-1b", **KNOBS[knobs])
    for phase in ("decode", "prefill"):
        assert pt.traffic.modeled_executed(phase) == \
            ref.traffic.modeled_executed(phase)
    assert pt.traffic._dispatch() == ref.traffic._dispatch() == \
        ("dense" if knobs == "dense" else "xla-oracle")


def test_ledger_tracks_quarantine():
    _, pt = _engines("olmo-1b")
    before = pt.traffic.per_role()
    path = next(e for e in pt.packed.manifest if e.packed).path
    pt.packed.quarantine(path, "test")
    pt.traffic.invalidate()
    after = pt.traffic.per_role()
    assert after[role_of(path)]["sparse_bytes"] > \
        before[role_of(path)]["sparse_bytes"]
    assert sum(r["sparse_bytes"] for r in after.values()) == \
        pt.weight_stream_report()["sparse_bytes_per_step"]


def test_phase_counters_match_trace_tracks(tmp_path):
    _, pt = _engines("olmo-1b", paged=True, page_len=8, prefill_chunk=8,
                     trace_out=str(tmp_path / "t.json"))
    rep, _ = _run(pt)
    ph = rep["traffic"]["phases"]
    assert ph["decode"]["weight_bytes"] == \
        ph["decode"]["steps"] * rep["traffic"]["weight"][
            "sparse_bytes_per_step"]
    assert ph["prefill"]["calls"] > 0 and ph["prefill"]["kv_write_bytes"] > 0
    stack = (rep["traffic"]["weight"]["sparse_bytes_per_step"]
             - rep["traffic"]["per_role"]["head"]["sparse_bytes"])
    assert ph["prefill"]["weight_bytes"] == ph["prefill"]["calls"] * stack
    pt.close()
    tracks = {}
    for e in load_trace(str(tmp_path / "t.json")):
        if e.get("ph") == "C" and e.get("cat") == "traffic":
            for k, v in e["args"].items():
                tracks[(e["name"], k)] = tracks.get((e["name"], k), 0) + v
    for phase in TRAFFIC_PHASES:
        for kind in TRAFFIC_KINDS:
            assert tracks[(f"hbm.{phase}", f"{kind}_bytes")] == \
                ph[phase][f"{kind}_bytes"]
            assert f"traffic.{phase}.{kind}_bytes" in pt.metrics.names


def test_roofline_is_the_h100s():
    """``memory_s`` is the phase's bytes over 3.35 TB/s, ``compute_s``
    its FLOPs over 989 TFLOP/s, and one card has no collective term."""
    assert HBM_BYTES_PER_S == 3.35e12 and BF16_FLOPS_PER_S == 989e12
    r = roofline(2e9, 6.7e9)
    assert r["memory_s"] == 6.7e9 / 3.35e12
    assert r["compute_s"] == 2e9 / 989e12
    assert r["collective_s"] == 0.0 and r["bottleneck"] == "memory"
    assert r["step_time_overlapped_s"] == r["memory_s"]
    _, pt = _engines("olmo-1b")
    rep, _ = _run(pt)
    dec = rep["traffic"]["phases"]["decode"]
    per_step = sum(dec[f"{k}_bytes"] for k in TRAFFIC_KINDS) / dec["steps"]
    rl = rep["traffic"]["roofline"]["decode"]
    assert rl["memory_s"] == per_step / 3.35e12
    assert rl["collective_s"] == 0.0


def test_energy_projection_orders_sparse_below_dense():
    _, pt = _engines("olmo-1b")
    rep, _ = _run(pt)
    en = rep["traffic"]["energy"]
    assert en["macs_per_token"] > 0
    assert 0 < en["pj_per_token"] < en["pj_per_token_dense"]
    assert en["tops_per_watt"] > en["tops_per_watt_dense"] > 0


def test_crosscheck_records_reason_and_artifact_is_written(tmp_path):
    """No compiled program to count: ``crosscheck()`` returns the
    dispatch, the reason and the modeled side without raising, and the
    artifact is written with the reference's schema; without
    ``traffic_out`` nothing is written and the tokens are the same."""
    _, off = _engines("olmo-1b", paged=True, page_len=8, prefill_chunk=8)
    _, toks_off = _run(off)
    assert off.close() == [] and off.traffic._crosscheck is None

    out = tmp_path / "traffic.json"
    _, pt = _engines("olmo-1b", paged=True, page_len=8, prefill_chunk=8,
                     traffic_out=str(out))
    _, toks = _run(pt)
    assert toks == toks_off
    cc = pt.traffic.crosscheck()
    assert cc["dispatch"] == "xla-oracle" and cc["reason"] == NO_HLO
    assert set(cc) == {"dispatch", "reason", "decode", "prefill"}
    assert cc["decode"]["modeled"] == pt.traffic.modeled_executed("decode")
    assert pt.close() == [str(out)] and pt.close() == []
    doc = json.loads(out.read_text())
    assert doc["schema"] == "repro.serve.traffic/v1"
    assert doc["arch"] == pt.cfg.name and doc["num_slots"] == 2
    assert doc["traffic"]["crosscheck"]["reason"] == NO_HLO
    assert math.isfinite(doc["traffic"]["energy"]["pj_per_token"])

"""The port's ServeEngine on the recurrent archs (rwkv6 and jamba smoke)
against a straight-line loop over the JAX package's ``decode_step``: one
request at a time, its prompt walked and its own greedy tokens fed back,
on the same pruned and packed weights.  Engines run in float32, where
the served tokens must be identical.

The reference's own ServeEngine is built here only to compare what it
packs, its traffic ledger and its fault targets: under JAX 0.9 its
jitted, mesh-sharded step stops on these archs with a
``ShardingTypeError``, so it serves nothing here.  Then the engine's own
cases: a slot reused after another request, preemption on a tight page
pool, and the auditor quarantining a corrupted K1 leaf or ``mix_B`` —
each serves the tokens of an undisturbed run.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as ref_M
from repro.serve import FaultPlan as RefPlan
from repro.serve import ServeEngine as RefEngine
from repro.serve.engine import pack_lm_head as ref_pack_lm_head
from repro.serve.packed import pack_model as ref_pack_model
from repro.sparse.pruning import global_l1_prune as ref_prune
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.serve import FaultPlan, RequestState, poisson_trace
from repro_torch.serve import ServeEngine as PtEngine

ARCHS = ("rwkv6-3b", "jamba-v0.1-52b")
SPARSITY = 0.5
MAX_LEN = 32
REF_STEP = jax.jit(ref_M.decode_step, static_argnums=(2,))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(reference cfg, port cfg, host params): float32 smoke configs and
    the reference's seeded init as numpy arrays."""
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype="float32")
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype="float32")
    return cfg, pcfg, jax.tree.map(
        np.asarray, ref_M.init_params(jax.random.PRNGKey(0), cfg))


def _engine(arch, **kw):
    _, pcfg, host = _weights(arch)
    kw = {"num_slots": 2, "max_len": MAX_LEN, "sparsity": SPARSITY, **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # fallback warnings
        return PtEngine(pcfg, params=params_from_numpy(host, device="cpu"),
                        device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _reference_step(arch):
    """The reference's serving weights: pruned globally, the stack packed
    by ``pack_model`` and the head by ``pack_lm_head``, as its engine
    packs them."""
    cfg, _, host = _weights(arch)
    params = ref_prune(jax.tree.map(jnp.asarray, host), SPARSITY)
    return (params, ref_pack_model(params).blocks,
            ref_pack_lm_head(params, cfg, SPARSITY))


def _reference_tokens(arch, prompt, budget):
    """One request through the reference's ``decode_step`` alone: the
    prompt walked (teacher forcing), then its greedy tokens fed back."""
    cfg = _weights(arch)[0]
    params, packed, lm = _reference_step(arch)
    cache = ref_M.init_cache(cfg, 1, MAX_LEN)
    ingest, out = list(prompt), []
    for pos in range(len(prompt) + budget - 1):
        logits, cache = REF_STEP(params, cache, cfg,
                                 jnp.asarray([[ingest[pos]]], jnp.int32),
                                 jnp.asarray([pos], jnp.int32),
                                 lm_weight=lm, packed=packed)
        if pos >= len(prompt) - 1:
            out.append(int(np.asarray(logits)[0].argmax()))
            ingest.append(out[-1])
    return out


def _serve(eng, trace):
    """Serve ``trace``; returns the tokens, the report, and the logits of
    each decoding slot by (prompt, position) — the last kept, so a
    replayed position holds the replay's."""
    log = {}
    decode = eng._decode

    def recording():
        out = decode()
        for slot, req in eng.scheduler.active.items():
            log[(tuple(req.prompt), int(eng._pos[slot]))] = \
                out[1][slot].numpy().copy()
        return out

    eng._decode = recording
    reqs = [eng.submit(**spec) for spec in trace]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # quarantine warnings
        rep = eng.run()
    for r in reqs:
        assert r.state is RequestState.DONE and r.error is None
        assert len(r.tokens) == r.max_new_tokens
    return [list(r.tokens) for r in reqs], rep, log


def _same_logits(got, want, prompts):
    """Every position of the requests with these prompts has the logits
    of the undisturbed run: any state left over from another request or
    a discarded step would move them."""
    keys = [k for k in want if k[0] in prompts]
    assert keys and all(k in got for k in keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6,
                                   err_msg=str(k))


TRACE = poisson_trace(6, rate=0.8, seed=7, max_new=(4, 8))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slots", [2, 4])
def test_engine_serves_reference_step_loop_tokens(arch, slots):
    """A seeded Poisson trace through the port's engine gives every
    request the tokens the reference's step loop gives it alone."""
    eng = _engine(arch, num_slots=slots)
    reset_launches()
    tokens, rep, _ = _serve(eng, TRACE)
    assert sum(LAUNCHES.values()) == 0     # the CPU takes the plain path
    assert rep["requests"] == len(TRACE)
    assert rep["fallbacks"] == {}
    for spec, got in zip(TRACE, tokens):
        assert got == _reference_tokens(arch, spec["prompt"],
                                        spec["max_new_tokens"]), spec


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_ledger_and_fault_targets_match_reference(arch):
    """What packs or falls back (jamba's x_proj (128, 12): no tile with
    BN % 8; its router (64, 4) likewise), the modeled weight bytes, the
    traffic ledger's role rows, and the packed leaves in the reference's
    order, from which a seeded bitflip draws the same tensor and bit;
    mix_B is a group stack with no
    routed-expert scaling."""
    cfg, pcfg, _ = _weights(arch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = RefEngine(cfg, num_slots=2, max_len=MAX_LEN, sparsity=SPARSITY)
    pt = _engine(arch)
    rows = [(e.path, tuple(e.shape), e.packed, e.reason, e.block,
             e.sparsity, e.sparse_bytes, e.dense_bytes, e.layout, e.experts)
            for e in ref.packed.manifest]
    assert rows == [(e.path, e.shape, e.packed, e.reason, e.block,
                     e.sparsity, e.sparse_bytes, e.dense_bytes, e.layout,
                     e.experts) for e in pt.packed.manifest]
    assert ref.weight_stream_report() == pt.weight_stream_report()
    assert ref.traffic.per_role() == pt.traffic.per_role()
    assert [p for p, _ in ref.packed.leaves()] == [
        p for p, _ in pt.packed.leaves()]
    by_path = {e.path: e for e in pt.packed.manifest}
    if arch == "jamba-v0.1-52b":
        xp = by_path["blocks/b0/mamba/x_proj"]
        assert not xp.packed and "no (BK, BN) tile divides (128, 12)" in \
            xp.reason
        assert by_path["blocks/b0/mamba/dt_proj"].block == (4, 128)
    else:
        mb = by_path["blocks/b0/rwkv/mix_B"]
        assert mb.packed and mb.layout == "grouped" and mb.experts == 0
    logs = []
    for eng, cls in ((ref, RefPlan), (pt, FaultPlan)):
        for field in ("values", "bitmap"):
            plan = cls(seed=5).bitflip(step=0, field=field)
            plan.fire(eng, 0)
            logs.append([(e["tensor"], e["field"], e["bit"])
                         for e in plan.log])
    assert logs[:2] == logs[2:]


@pytest.mark.parametrize("arch,paged", [("rwkv6-3b", False),
                                        ("jamba-v0.1-52b", False),
                                        ("jamba-v0.1-52b", True)])
def test_reused_slot_serves_fresh_engine_tokens(arch, paged):
    """One slot serves request A, then B: B's tokens are those of a fresh
    engine serving B alone — admission zeroed the recurrent state A left
    (the contiguous cache's ``reset_slot``, the paged cache's ``admit``
    for the slotted leaves)."""
    kw = dict(num_slots=1, paged=paged, page_len=8)
    a = {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 6, "arrival": 0.0}
    b = {"prompt": [9, 2, 6], "max_new_tokens": 6, "arrival": 0.0}
    tokens, rep, log = _serve(_engine(arch, **kw), [a, b])
    fresh, _, fresh_log = _serve(_engine(arch, **kw), [b])
    assert rep["cache_resets"] == 2 and rep["paging"]["paged"] == paged
    assert tokens[1] == fresh[0]
    _same_logits(log, fresh_log, [tuple(b["prompt"])])


def test_jamba_paged_preempt_on_tight_pool_serves_uncontended_tokens():
    """Paged jamba with recompute-on-preempt on a pool too small for
    both slots: preemptions happen, and each replay (its slot's mamba
    state zeroed on re-admission) serves the tokens of the uncontended
    contiguous run."""
    trace = [{"prompt": [5 + i, 7, 11, 13, 2 + i, 8], "max_new_tokens": 10,
              "arrival": float(i)} for i in range(3)]
    want, _, want_log = _serve(_engine("jamba-v0.1-52b", num_slots=2),
                               trace)
    eng = _engine("jamba-v0.1-52b", num_slots=2, paged=True, page_len=4,
                  page_pool_tokens=24, preempt=True)
    got, rep, log = _serve(eng, trace)
    assert rep["prefix_reuse"]["preempt"]["count"] >= 1
    eng.kv.audit()
    assert got == want
    _same_logits(log, want_log, [tuple(t["prompt"]) for t in trace])


@pytest.mark.parametrize("tensor", ["blocks/b0/rwkv/w_k",
                                    "blocks/b0/rwkv/mix_B"])
def test_rwkv_audit_quarantines_corrupt_leaf_and_serves_clean_tokens(tensor):
    """A bit flipped in a K1 leaf (w_k) or in the K1g group stack
    (mix_B): the auditor finds it, quarantines the leaf to dense, and
    every request replays from position 0 (its state zeroed) to the
    clean run's tokens."""
    trace = [{"prompt": [4, 8, 15], "max_new_tokens": 8, "arrival": 0.0},
             {"prompt": [16, 23, 42, 7], "max_new_tokens": 8,
              "arrival": 1.0}]
    clean, _, clean_log = _serve(_engine("rwkv6-3b"), trace)
    eng = _engine("rwkv6-3b", audit=True,
                  faults=FaultPlan(seed=3).bitflip(step=4, tensor=tensor))
    got, _, log = _serve(eng, trace)
    assert eng.faults.summary()["fired"] == 1
    assert tensor in eng.quarantined
    assert eng.packed.blocks["b0"]["rwkv"][tensor.split("/")[-1]] is None
    assert got == clean
    _same_logits(log, clean_log, [tuple(t["prompt"]) for t in trace])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_builds_its_own_weights_and_serves(arch):
    """With no params the engine draws its own (bfloat16 compute, the
    served type) and serves."""
    eng = PtEngine(pt_smoke(arch), num_slots=2, max_len=MAX_LEN,
                   sparsity=SPARSITY, device="cpu")
    tokens, rep, _ = _serve(eng, TRACE[:2])
    assert rep["requests"] == 2 and all(0 <= t < 256 for t in tokens[0])

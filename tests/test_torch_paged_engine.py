"""Port's paged engine against the JAX package's: the paged engine step
for step (tokens and host page tables), shared-prefix reuse and
recompute-on-preempt with the reference's counters, the fallbacks, and
the CLI.  Engines run in float32, where the served tokens must be
identical.  The paged model step is held in
``tests/test_torch_paged_model.py``.
"""
import dataclasses
import math
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
from repro.serve import ServeEngine as RefEngine
from repro.serve import RequestRejected as RefRejected
from repro.serve import poisson_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.device import NoCudaDevice
from repro_torch.serve import RequestRejected
from repro_torch.serve import ServeEngine as PtEngine
from repro_torch.serve.engine import kv_fallbacks

# gemma3's smoke window is 8: page length 3 rounds its ring up to 9 lines
PAGE_LEN = {"olmo-1b": 8, "gemma3-4b": 3, "granite-moe-3b-a800m": 8}


# ------------------------------------------------------------ engine ----


def _engines(arch, chunk, sparsity, **kw):
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype="float32")
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype="float32")
    params = jax.tree.map(np.asarray,
                          ref_M.init_params(jax.random.PRNGKey(0), cfg))
    common = dict(num_slots=kw.pop("num_slots", 4),
                  max_len=kw.pop("max_len", 48), sparsity=sparsity, seed=0,
                  prefill_chunk=chunk, **kw)
    ref = RefEngine(cfg, **common)
    pt = PtEngine(pcfg, params=params_from_numpy(params, device="cpu"),
                  device="cpu", **common)
    return ref, pt


def _drive(engine, trace):
    """``run()`` step by step, recording the host page tables after
    every step."""
    reqs = [engine.submit(**spec) for spec in trace]
    engine.warmup()
    tables = []
    while engine.scheduler.has_work:
        if not engine.scheduler.active:
            nxt = engine.scheduler.next_arrival()
            if nxt > engine._steps:
                engine._steps = int(math.ceil(nxt))
        engine.step()
        tables.append({b: p.table.copy() for b, p in engine.kv.pools.items()})
    return reqs, tables, engine.report()


CASES = [(arch, chunk, sp) for arch in ("olmo-1b", "gemma3-4b")
         for chunk in (0, 4) for sp in (0.0, 0.5)]
CASES.append(("granite-moe-3b-a800m", 4, 0.5))


@pytest.mark.parametrize("arch,chunk,sparsity", CASES)
def test_paged_engine_matches_reference_step_for_step(arch, chunk,
                                                      sparsity):
    """A pool below the worst case (admissions queue for pages): tokens
    identical to the reference engine's, host page tables equal after
    every step, and the paging and prefill sections equal."""
    ref, pt = _engines(arch, chunk, sparsity, paged=True,
                       page_len=PAGE_LEN[arch], page_pool_tokens=72)
    trace = poisson_trace(6, rate=0.8, seed=5, vocab_size=pt.cfg.vocab_size,
                          prompt_len=(2, 14), max_new=(4, 10))
    ref_reqs, ref_tables, ref_rep = _drive(ref, trace)
    pt_reqs, pt_tables, pt_rep = _drive(pt, trace)
    assert [r.tokens for r in ref_reqs] == [r.tokens for r in pt_reqs]
    assert all(len(r.tokens) == r.max_new_tokens for r in pt_reqs)
    assert len(ref_tables) == len(pt_tables)
    for i, (a, b) in enumerate(zip(ref_tables, pt_tables)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"step {i}")
    assert ref_rep["paging"] == pt_rep["paging"]
    for key in ("prefill_steps", "decode_steps", "calls",
                "tokens_prefilled"):
        assert ref_rep["prefill"][key] == pt_rep["prefill"][key], key
    assert pt_rep["paging"]["pages_in_use"] == 0
    assert pt_rep["cache_resets"] == ref_rep["cache_resets"]
    pt.kv.audit()


def _shared_trace(n=5, plen=18, arrivals=12):
    """The reference's shared-prompt trace: one 18-token prompt, later
    requests admitted while or after earlier ones hold its blocks."""
    prompt = list(range(1, plen + 1))
    return [{"prompt": prompt, "max_new_tokens": 5,
             "arrival": float(i * arrivals)} for i in range(n)]


PREFIX_KEYS = ("enabled", "fallback", "hit_requests", "miss_requests",
               "cached_blocks", "cached_tokens", "shareable_tokens", "hits",
               "misses", "hit_rate", "hit_tokens", "evictions", "forks",
               "preempt")


@pytest.mark.parametrize("arch,chunk", [("olmo-1b", 0), ("olmo-1b", 4),
                                        ("gemma3-4b", 0), ("gemma3-4b", 4)])
def test_reuse_and_preempt_match_reference(arch, chunk):
    """``prefix_reuse`` + ``preempt`` on a 64-token pool: tokens equal
    the reference engine's and the plain paged run's, and the
    prefix-reuse section (hits, hit tokens, forks, evictions,
    preemptions, recomputed tokens) equals the reference's."""
    kw = dict(paged=True, page_len=8, page_pool_tokens=64,
              prefix_reuse=True, preempt=True, num_slots=2, max_len=32)
    ref, pt = _engines(arch, chunk, 0.0, **kw)
    trace = _shared_trace()
    ref_reqs, ref_tables, ref_rep = _drive(ref, trace)
    pt_reqs, pt_tables, pt_rep = _drive(pt, trace)
    _, plain = _engines(arch, chunk, 0.0, paged=True, page_len=8,
                        num_slots=2, max_len=32)
    plain_reqs, _, _ = _drive(plain, trace)
    tokens = [r.tokens for r in pt_reqs]
    assert tokens == [r.tokens for r in ref_reqs]
    assert tokens == [r.tokens for r in plain_reqs]
    for key in PREFIX_KEYS:
        assert ref_rep["prefix_reuse"][key] == pt_rep["prefix_reuse"][key], \
            key
    assert pt_rep["prefix_reuse"]["hits"] >= 1
    assert [r.prefix_hit_tokens for r in pt_reqs] == \
        [r.prefix_hit_tokens for r in ref_reqs]
    for a, b in zip(ref_tables, pt_tables):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    pt.kv.audit()


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-4b"])
def test_preemption_recomputes_the_reference_tokens(arch):
    """Four requests in a pool too small for all of them: preemptible
    mode preempts and recomputes; tokens, preemptions and recomputed
    tokens equal the reference's, and the strict run's tokens."""
    trace = [{"prompt": [i + 1, i + 2], "max_new_tokens": 12,
              "arrival": 0.0} for i in range(4)]
    kw = dict(paged=True, page_len=8, page_pool_tokens=48, max_len=32)
    ref, pt = _engines(arch, 0, 0.0, preempt=True, **kw)
    ref_reqs, ref_tables, ref_rep = _drive(ref, trace)
    pt_reqs, pt_tables, pt_rep = _drive(pt, trace)
    _, strict = _engines(arch, 0, 0.0, **kw)
    strict_reqs, _, _ = _drive(strict, trace)
    assert [r.tokens for r in pt_reqs] == [r.tokens for r in ref_reqs] \
        == [r.tokens for r in strict_reqs]
    pe = pt_rep["prefix_reuse"]["preempt"]
    assert pe == ref_rep["prefix_reuse"]["preempt"]
    assert pe["count"] >= 1 and pe["recomputed_tokens"] > 0
    assert [len(r.t_preempt) for r in pt_reqs] == \
        [len(r.t_preempt) for r in ref_reqs]
    assert [r.recomputed_tokens for r in pt_reqs] == \
        [r.recomputed_tokens for r in ref_reqs]
    for a, b in zip(ref_tables, pt_tables):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert pt_rep["paging"]["pages_in_use"] == 0


def test_preempted_sampled_request_recomputes_identical_tokens():
    """Sampling noise depends on (seed, position) only: a preempted
    sampled request recomputes the tokens of the strict run."""
    cfg = pt_smoke("olmo-1b")

    def go(preempt, max_preempts=8):
        eng = PtEngine(cfg, num_slots=4, max_len=32, seed=0, paged=True,
                       page_len=8, page_pool_tokens=48, preempt=preempt,
                       max_preempts=max_preempts, device="cpu")
        reqs = [eng.submit([i + 1, i + 2], max_new_tokens=12,
                           temperature=1.0, seed=100 + i)
                for i in range(4)]
        eng.run()
        return eng, [r.tokens for r in reqs]

    _, strict = go(False)
    eng, relaxed = go(True)
    assert relaxed == strict
    assert eng.report()["prefix_reuse"]["preempt"]["count"] >= 1
    assert any(r.t_preempt for r in eng.requests)
    # a budget of one: every request is pinned after its first
    # preemption and still serves the same tokens
    pinned, tokens = go(True, max_preempts=1)
    assert tokens == strict
    assert max(len(r.t_preempt) for r in pinned.requests) == 1
    pinned.kv.audit()


@pytest.mark.parametrize("arch,chunk", [("olmo-1b", 4),
                                        ("granite-moe-3b-a800m", 0)])
def test_sampled_paged_engine_equals_reference(arch, chunk):
    """Sampled requests (T 0.8 / 1.0, per-request top-k 0 and 3, the
    rest at the engine's top-k 4) with staggered arrivals on the paged
    engine: every token equals the reference paged engine's, the
    sampled draws replayed from the reference's keys."""
    ref, pt = _engines(arch, chunk, 0.5, num_slots=3, top_k=4, paged=True,
                       page_len=PAGE_LEN[arch])
    trace = []
    for i in range(6):
        spec = dict(prompt=[(7 * i + j) % 250 + 1 for j in range(3 + i)],
                    max_new_tokens=6, arrival=float(i))
        if i % 3:
            spec.update(temperature=(0.8, 1.0)[i % 2], seed=60 + i)
            if i > 2:
                spec["top_k"] = (0, 3)[i % 2]
        trace.append(spec)
    ref_reqs, ref_tables, _ = _drive(ref, trace)
    pt_reqs, pt_tables, _ = _drive(pt, trace)
    assert [list(r.tokens) for r in pt_reqs] == \
        [[int(t) for t in r.tokens] for r in ref_reqs]
    assert len(pt_tables) == len(ref_tables)


# --------------------------------------------------------- fallbacks ----


def test_fallback_reasons_and_warnings_match_reference():
    """Without paging, prefix reuse and preemption fall back with the
    reference engine's reasons and warnings; an arch with no attention
    block falls back from paging; frames and recurrent archs from
    reuse.  The port's engine warns as the reference's does."""
    for arch, kw in (("olmo-1b", dict(prefix_reuse=True, preempt=True)),
                     ("rwkv6-3b", dict(paged=True, prefix_reuse=True,
                                       preempt=True)),
                     ("musicgen-medium", dict(paged=True, prefix_reuse=True,
                                              preempt=True))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ref = RefEngine(ref_smoke(arch), num_slots=2, max_len=16, **kw)
        got = kv_fallbacks(pt_smoke(arch), kw.get("paged", False),
                           True, True)
        assert got == {"paging": ref.paging_fallback,
                       "prefix_reuse": ref.prefix_fallback,
                       "preempt": ref.preempt_fallback}, arch
        ref_msgs = [str(w.message) for w in caught
                    if "fell back" in str(w.message)]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pt = PtEngine(pt_smoke(arch), num_slots=2, max_len=16,
                          device="cpu", **kw)
        assert [str(w.message) for w in caught
                if "fell back" in str(w.message)] == ref_msgs
        assert not pt.prefix_reuse and not pt.preempt
        assert pt.report()["fallbacks"] == ref.fallbacks
    reason = kv_fallbacks(pt_smoke("jamba-v0.1-52b"), True, True, False)
    assert "recurrent" in reason["prefix_reuse"] and not reason["paging"]


def test_impossible_page_need_is_rejected_typed():
    kw = dict(num_slots=2, max_len=16, seed=0, paged=True, page_len=8,
              page_pool_tokens=8, prefix_reuse=True, preempt=True)
    ref = RefEngine(ref_smoke("olmo-1b"), **kw)
    pt = PtEngine(pt_smoke("olmo-1b"), device="cpu", **kw)
    msgs = []
    for eng in (ref, pt):
        with pytest.raises((RequestRejected, RefRejected)) as err:
            eng.submit([1], max_new_tokens=16)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "raise page_pool_tokens" in msgs[1]
    req = pt.submit([1], max_new_tokens=3)
    pt.run()
    assert len(req.tokens) == 3


def test_paged_engine_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        PtEngine(pt_smoke("olmo-1b"), paged=True, prefix_reuse=True)


def test_cli_paged_reuse_preempt(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--paged",
          "--page-len", "8", "--prefix-reuse", "--preempt",
          "--page-pool-tokens", "48", "--requests", "6"])
    out = capsys.readouterr().out
    assert "6 requests" in out
    assert "paged KV:" in out and "prefix reuse:" in out
    assert "preemption:" in out

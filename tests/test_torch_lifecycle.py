"""Port's request lifecycle against the JAX package's: cancellation at
every stage, deadlines, load shedding, bounded preemption under a forced
preemption storm, and the terminal-state taxonomy.  Each case drives the
port's engine and the reference engine through the same steps (wall
time decides nothing in them) and requires the same states, tokens and
lifecycle counters; engines run in float32.
"""
import dataclasses
import warnings

import numpy as np
import pytest

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as ref_M
from repro.serve import FaultPlan as RefPlan
from repro.serve import ServeEngine as RefEngine
from repro.serve import ServeOverloaded as RefOverloaded
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.serve import (AuditViolation, DeadlineExceeded, FaultPlan,
                               OutOfPages, Request, RequestRejected,
                               RequestState, ServeError, ServeOverloaded)
from repro_torch.serve import ServeEngine as PtEngine
from repro_torch.serve.request import TERMINAL_STATES

CFG = dataclasses.replace(ref_smoke("olmo-1b"), compute_dtype="float32")
PCFG = dataclasses.replace(pt_smoke("olmo-1b"), compute_dtype="float32")
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [4, 5, 6], [1, 2, 3, 4, 5, 6],
           [9, 8, 7, 6, 5]]
FULL = dict(paged=True, page_len=8, prefix_reuse=True, preempt=True,
            prefill_chunk=4)
# the lifecycle report's fields that no wall clock decides
LC_KEYS = ("deadline_ms", "max_queue", "ttft_budget_ms", "max_preempts",
           "cancelled", "expired", "shed", "forced_preempts",
           "wasted_tokens", "terminal_states", "quarantined")


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray,
                        ref_M.init_params(jax.random.PRNGKey(0), CFG))


def _pair(params, **kw):
    """The reference engine and the port's on the same weights."""
    kw = {"num_slots": 2, "max_len": 48, "sparsity": 0.5, "seed": 0, **kw}
    plan = kw.pop("faults", None)
    ref_kw, pt_kw = dict(kw), dict(kw)
    if plan is not None:
        ref_kw["faults"], pt_kw["faults"] = plan(RefPlan), plan(FaultPlan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # fallback warnings
        ref = RefEngine(CFG, **ref_kw)
        pt = PtEngine(PCFG, params=params_from_numpy(params, device="cpu"),
                      device="cpu", **pt_kw)
    return ref, pt


def _submit_all(eng, n=4, max_new=6):
    return [eng.submit(PROMPTS[i % len(PROMPTS)], max_new,
                       arrival=float(i)) for i in range(n)]


def _drain(eng, cancels=None, edits=None):
    """Step until drained; before step i, cancel the rids of
    ``cancels[i]`` and run ``edits[i](eng)``.  Returns the states and
    tokens of every request ever retired, by rid."""
    cancels, edits = cancels or {}, edits or {}
    step = 0
    while eng.scheduler.has_work:
        for rid in cancels.get(step, []):
            eng.cancel(rid)
        if step in edits:
            edits[step](eng)
        eng.step()
        step += 1
        assert step < 10_000, "engine failed to drain"
    return {r.rid: (r.state.name, list(r.tokens), type(r.error).__name__)
            for r in eng.requests}


def _same(ref, pt, **drive):
    """Drive both engines alike; their outcomes and lifecycle counters
    must be equal.  Returns the port's outcome."""
    got = {side: _drain(eng, **drive) for side, eng in
           (("ref", ref), ("pt", pt))}
    assert got["pt"] == got["ref"]
    lc = {side: eng.report()["lifecycle"] for side, eng in
          (("ref", ref), ("pt", pt))}
    for key in LC_KEYS:
        assert lc["pt"][key] == lc["ref"][key], key
    return got["pt"]


def _no_leak(eng):
    if eng.page_len:
        eng.kv.flush_prefix()
        eng.kv.audit()
        for pool in eng.kv.pools.values():
            assert not pool.ref and not pool.held


# ------------------------------------------------------ error taxonomy ----


def test_error_hierarchy_and_state_machine():
    assert issubclass(RequestRejected, ServeError)
    assert issubclass(RequestRejected, ValueError)
    assert issubclass(OutOfPages, ServeError)
    assert issubclass(OutOfPages, RuntimeError)
    assert issubclass(ServeOverloaded, ServeError)
    assert issubclass(DeadlineExceeded, ServeError)
    assert issubclass(AuditViolation, ServeError)
    assert issubclass(AuditViolation, AssertionError)
    e = ServeOverloaded("queue full", queue_depth=7, est_ttft_s=0.5)
    assert e.queue_depth == 7 and e.est_ttft_s == 0.5
    req = Request(rid=0, prompt=[1], max_new_tokens=1)
    req.transition(RequestState.WAITING)
    req.transition(RequestState.ACTIVE)
    with pytest.raises(AuditViolation):
        req.transition(RequestState.SHED)
    req.transition(RequestState.DONE)
    with pytest.raises(AuditViolation):
        req.transition(RequestState.WAITING)
    assert TERMINAL_STATES == {RequestState.DONE, RequestState.CANCELLED,
                               RequestState.EXPIRED, RequestState.SHED}


# -------------------------------------------------------- cancellation ----


def test_cancel_queued_and_unknown_rid(params):
    ref, pt = _pair(params)
    for eng in (ref, pt):
        reqs = _submit_all(eng)
        assert eng.cancel(reqs[3].rid)
        assert reqs[3].state.name == "CANCELLED"
        assert reqs[3].error is None and reqs[3].result() == []
        assert not eng.cancel(reqs[3].rid) and not eng.cancel(999)
    out = _same(ref, pt)
    assert out[3] == ("CANCELLED", [], "NoneType")
    assert [out[i][0] for i in range(3)] == ["DONE"] * 3
    assert pt.report()["lifecycle"]["cancelled"] == 1


@pytest.mark.parametrize("kw", [
    dict(),
    dict(paged=True, page_len=8, prefill_chunk=4),
    FULL,
], ids=["contig", "mid-prefill", "full-stack"])
@pytest.mark.parametrize("at", [1, 2, 5])
def test_cancel_mid_flight_matches_reference(params, kw, at):
    """Cancel one request mid-prefill or mid-decode: the outcome equals
    the reference's, the survivors' tokens equal the undisturbed run's,
    the victim's partial tokens are a prefix of its undisturbed ones,
    and no page leaks."""
    _, base_eng = _pair(params, **kw)
    _submit_all(base_eng)
    base = _drain(base_eng)
    ref, pt = _pair(params, **kw)
    for eng in (ref, pt):
        _submit_all(eng)
    out = _same(ref, pt, cancels={at: [1]})
    for rid, (state, toks, _) in out.items():
        if rid == 1 and state == "CANCELLED":
            assert base[rid][1][:len(toks)] == toks
        else:
            assert (state, toks) == base[rid][:2], rid
    _no_leak(pt)


@pytest.mark.parametrize("victim,at,extra", [(0, 0, 2), (1, 3, 1),
                                             (2, 6, 0), (3, 9, 3),
                                             (1, 12, 2)])
def test_cancel_interleavings_match_reference(params, victim, at, extra):
    """Cancels at chosen (victim, step) points, sometimes a second one a
    step later, on the full paged stack over a 96-token pool."""
    kw = dict(FULL, page_pool_tokens=96)
    ref, pt = _pair(params, **kw)
    for eng in (ref, pt):
        _submit_all(eng)
    cancels = {at: [victim]}
    if extra != victim:
        cancels.setdefault(at + 1, []).append(extra)
    out = _same(ref, pt, cancels=cancels)
    assert all(state in ("DONE", "CANCELLED") for state, _, _ in
               out.values())
    _no_leak(pt)


def test_cancel_mid_preempt_replay(params):
    """Cancel a request while it waits, preempted, to replay."""
    ref, pt = _pair(params, **FULL)
    victims = {}

    def preempt_youngest(eng):
        slot = max(eng.scheduler.active,
                   key=lambda s: int(eng._admit_seq[s]))
        victims[id(eng)] = eng.scheduler.active[slot]
        eng._preempt_slot(slot)
        req = victims[id(eng)]
        assert req.state.name == "WAITING" and req.t_preempt
        assert eng.cancel(req.rid)

    for eng in (ref, pt):
        _submit_all(eng)
    out = _same(ref, pt, edits={4: preempt_youngest})
    assert victims[id(pt)].state is RequestState.CANCELLED
    assert sum(s == "CANCELLED" for s, _, _ in out.values()) == 1
    _no_leak(pt)


# ------------------------------------------------------------ deadlines ----


def test_deadline_expires_queued_request(params):
    ref, pt = _pair(params, num_slots=1, max_len=64)
    for eng in (ref, pt):
        eng.submit(list(range(1, 5)), 30, arrival=0.0)
        eng.submit([1, 2, 3], 5, arrival=0.0, deadline_ms=0.0)
    out = _same(ref, pt)
    assert out[0][0] == "DONE"
    assert out[1] == ("EXPIRED", [], "DeadlineExceeded")
    starved = pt.requests[0]
    with pytest.raises(DeadlineExceeded):
        starved.result()
    assert pt.report()["lifecycle"]["expired"] == 1


def test_deadline_expires_mid_decode_keeps_partial_tokens(params):
    ref, pt = _pair(params)
    for eng in (ref, pt):
        eng.submit([1, 2, 3], 40, arrival=0.0, deadline_ms=1e9)
        eng.submit([4, 5, 6], 4, arrival=0.0)

    def tighten(eng):
        req = next(r for r in eng.scheduler.active.values() if r.rid == 0)
        req.deadline_ms = 0.0          # its budget just ran out

    out = _same(ref, pt, edits={6: tighten})
    state, toks, err = out[0]
    assert (state, err) == ("EXPIRED", "DeadlineExceeded")
    assert 0 < len(toks) < 40
    expired = next(r for r in pt.requests if r.rid == 0)
    assert "mid-flight" in str(expired.error)
    assert out[1][0] == "DONE" and len(out[1][1]) == 4


def test_generous_deadline_never_fires(params):
    ref, pt = _pair(params, deadline_ms=600_000.0)
    for eng in (ref, pt):
        _submit_all(eng)
    out = _same(ref, pt)
    assert all(state == "DONE" for state, _, _ in out.values())


# --------------------------------------------------------- load shedding ----


def test_submit_time_shedding_raises_typed(params):
    ref, pt = _pair(params, num_slots=1, max_queue=2)
    for eng in (ref, pt):
        eng.submit([1, 2], 20, arrival=0.0)
        eng.submit([3, 4], 4, arrival=0.0)
        with pytest.raises((ServeOverloaded, RefOverloaded)) as ei:
            eng.submit([5, 6], 4, arrival=0.0)
        assert ei.value.queue_depth >= 2
    assert pt.report()["lifecycle"]["shed"] == 1
    _same(ref, pt)
    assert pt.report()["lifecycle"]["shed"] == 1


def test_due_time_shedding_records_silently(params):
    ref, pt = _pair(params, num_slots=1, max_len=64, max_queue=1)
    for eng in (ref, pt):
        eng.submit(list(range(1, 5)), 24, arrival=0.0)
        for _ in range(3):
            eng.submit([1, 2, 3], 4, arrival=2.0)
    out = _same(ref, pt)
    states = [out[rid][0] for rid in (1, 2, 3)]
    assert "SHED" in states
    for req in pt.requests:
        if req.state is RequestState.SHED:
            with pytest.raises(ServeOverloaded):
                req.result()
    lc = pt.report()["lifecycle"]
    assert lc["shed"] == states.count("SHED")
    assert lc["terminal_states"]["SHED"] == lc["shed"]


def test_no_shedding_configured_never_rejects(params):
    ref, pt = _pair(params, num_slots=1)
    for eng in (ref, pt):
        for _ in range(6):
            eng.submit([1, 2, 3], 6, arrival=0.0)
    out = _same(ref, pt)
    assert [s for s, _, _ in out.values()] == ["DONE"] * 6


def test_estimated_ttft_matches_reference(params):
    """The TTFT estimate is the reference's arithmetic: the outstanding
    tokens spread over the slots at the step wall's moving average."""
    ref, pt = _pair(params, num_slots=2)
    for eng in (ref, pt):
        assert eng.estimated_ttft_s() is None
        _submit_all(eng, n=4, max_new=8)
        for _ in range(3):
            eng.step()
        eng._step_wall_ema = 0.125
    assert pt.estimated_ttft_s() == ref.estimated_ttft_s() > 0
    for eng in (ref, pt):
        eng.ttft_budget_ms = 1000.0
        eng._step_wall_ema = 10.0      # 10 s per step: over the budget
    assert pt._overload_reason() == ref._overload_reason()
    assert "estimated TTFT" in pt._overload_reason()


# ------------------------------------------------- bounded preemption ----


def test_forced_preempt_storm_respects_max_preempts(params):
    """A preemption storm cannot preempt any request more than
    ``max_preempts`` times; every request finishes with the undisturbed
    run's tokens, as in the reference."""
    kw = dict(FULL, max_len=64)
    _, base_eng = _pair(params, **kw)
    _submit_all(base_eng, max_new=8)
    base = _drain(base_eng)

    def storm(cls):
        plan = cls(seed=0)
        for s in range(2, 26, 2):
            plan.force_preempt(step=s, count=1)
        return plan

    ref, pt = _pair(params, max_preempts=2, faults=storm, audit=True, **kw)
    for eng in (ref, pt):
        _submit_all(eng, max_new=8)
    out = _same(ref, pt)
    assert pt._forced_preempts > 0
    assert out == base
    assert all(len(r.t_preempt) <= 2 for r in pt.requests)
    _no_leak(pt)


# ------------------------------------------------------ taxonomy totals ----


def test_terminal_taxonomy_partitions_history(params):
    ref, pt = _pair(params, num_slots=1, max_len=64, max_queue=2)
    for eng in (ref, pt):
        eng.submit(list(range(1, 5)), 20, arrival=0.0)
        eng.submit([1, 2], 4, arrival=0.0, deadline_ms=0.0)
        eng.submit([3, 4], 4, arrival=1.0)
        eng.submit([5, 6], 4, arrival=1.0)
        cancel_me = eng.submit([7, 8], 4, arrival=2.0)
        eng.cancel(cancel_me.rid)
    _same(ref, pt)
    lc = pt.report()["lifecycle"]
    tax = lc["terminal_states"]
    assert sum(tax.values()) == len(pt.requests) == 5
    assert tax.get("CANCELLED", 0) == lc["cancelled"] == 1
    assert tax.get("EXPIRED", 0) == lc["expired"]
    assert tax.get("SHED", 0) == lc["shed"]
    assert lc["wasted_tokens"] >= 0


def test_fallback_warnings_dedupe_and_mirror_into_report(params):
    _, pt = _pair(params)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pt._warn_fallback("k", "some reason", "message one")
        pt._warn_fallback("k", "some reason", "message one")
        pt._warn_fallback("k", "other reason", "message two")
    assert [str(x.message) for x in w] == ["message one", "message two"]
    assert pt.report()["fallbacks"]["k"] == "other reason"

"""Port's fault injection and invariant auditor against the JAX
package's: the same pack-time checksums, the same seeded chaos schedule
and fault log (kind, step, tensor, bit), and every fault kind recovering
to the clean run's tokens — the port's and the reference engine's faulted
run's.  Engines run in float32, where tokens must be identical.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as ref_M
from repro.serve import FaultPlan as RefPlan
from repro.serve import ServeEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.serve import FaultPlan, RequestState
from repro_torch.serve import ServeEngine as PtEngine
from repro_torch.serve.faults import FAULT_KINDS, _checksum

PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [4, 5, 6],
           [1, 2, 3, 4, 5, 6], [9, 8, 7, 6, 5]]
FULL = dict(paged=True, page_len=8, prefix_reuse=True, preempt=True,
            prefill_chunk=4)


def _params(arch):
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype="float32")
    return cfg, jax.tree.map(np.asarray,
                             ref_M.init_params(jax.random.PRNGKey(0), cfg))


def _engine(side, arch="olmo-1b", **kw):
    cfg, params = _params(arch)
    kw = {"num_slots": 2, "max_len": 64, "sparsity": 0.5, "seed": 0, **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # fallback warnings
        if side == "ref":
            return RefEngine(cfg, **kw)
        pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype="float32")
        return PtEngine(pcfg, params=params_from_numpy(params, device="cpu"),
                        device="cpu", **kw)


def _run(eng, max_new=6):
    reqs = [eng.submit(p, max_new, arrival=float(i))
            for i, p in enumerate(PROMPTS)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # quarantine warnings expected
        rep = eng.run()
    return rep, {r.rid: list(r.tokens) for r in reqs}


def _assert_clean(eng):
    """Every request DONE with no error, no page leaked after drain."""
    for r in eng.requests:
        assert r.state is RequestState.DONE and r.error is None
    if eng.page_len:
        eng.kv.flush_prefix()
        eng.kv.audit()
        for pool in eng.kv.pools.values():
            assert not pool.ref and not pool.held


def _plan(cls, kind):
    p = cls(seed=11)
    return {"page_squeeze": lambda: p.page_squeeze(step=4, pages=6,
                                                   duration=5),
            "force_preempt": lambda: p.force_preempt(step=4, count=1),
            "evict_storm": lambda: p.evict_storm(step=5),
            "nan_logits": lambda: p.nan_logits(step=4),
            "bitflip": lambda: p.bitflip(step=5)}[kind]()


@pytest.fixture(scope="module")
def clean():
    """The port's fault-free tokens under the full paged stack."""
    return _run(_engine("pt", **FULL))[1]


# ------------------------------------------------------------ checksums ----


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m",
                                  "gemma3-4b"])
def test_checksums_equal_reference(arch):
    """CRC32 over each packed tensor's host bytes (bits, values, row
    starts) equals the reference's for every stack leaf and the head."""
    ref = _engine("ref", arch, audit=True)
    pt = _engine("pt", arch, audit=True)
    assert list(pt.auditor._sums) == list(ref.auditor._sums)
    assert pt.auditor._sums == ref.auditor._sums
    assert ("lm_head" in pt.auditor._sums) == (pt.lm_weight is not None)
    for path, bw in pt.packed.leaves():
        assert _checksum(bw) == pt.auditor._sums[path]
    assert pt.auditor.integrity_scan() == []


# ------------------------------------------------------- chaos schedule ----


@pytest.mark.parametrize("seed,horizon", [(3, 24), (9, 20)])
def test_chaos_schedule_and_log_equal_reference(seed, horizon):
    """``FaultPlan.chaos`` draws the same schedule as the reference, and
    on the same engine knobs fires the same log: kinds, steps, pages,
    victims, the bitflip's tensor, field and bit."""
    plans = {"ref": RefPlan.chaos(seed=seed, horizon=horizon),
             "pt": FaultPlan.chaos(seed=seed, horizon=horizon)}
    sched = {side: [dataclasses.asdict(f) for f in p.faults]
             for side, p in plans.items()}
    assert sched["pt"] == sched["ref"]
    reps, toks = {}, {}
    for side, plan in plans.items():
        eng = _engine(side, audit=True, faults=plan, **FULL)
        reps[side], toks[side] = _run(eng)
    fs = {side: rep["lifecycle"]["faults"] for side, rep in reps.items()}
    assert fs["pt"] == fs["ref"]
    assert sorted(fs["pt"]["by_kind"]) == sorted(FAULT_KINDS)
    flips = [e for e in fs["pt"]["log"] if e["kind"] == "bitflip"]
    assert flips and "bit" in flips[0] and "tensor" in flips[0]
    assert toks["pt"] == toks["ref"]
    assert reps["pt"]["lifecycle"]["quarantined"] == \
        reps["ref"]["lifecycle"]["quarantined"]


# --------------------------------------------------- per-fault recovery ----


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_each_fault_recovers_to_clean_and_reference_tokens(kind, clean):
    pt = _engine("pt", audit=True, faults=_plan(FaultPlan, kind), **FULL)
    rep, toks = _run(pt)
    ref_rep, ref_toks = _run(_engine("ref", audit=True,
                                     faults=_plan(RefPlan, kind), **FULL))
    fs = rep["lifecycle"]["faults"]
    assert fs["fired"] >= 1, f"{kind} never fired: {fs['log']}"
    assert fs == ref_rep["lifecycle"]["faults"]
    assert toks == clean, f"{kind}: tokens diverged from the clean run"
    assert toks == ref_toks
    _assert_clean(pt)
    lc = rep["lifecycle"]
    assert lc["quarantined"] == ref_rep["lifecycle"]["quarantined"]
    if kind in ("nan_logits", "bitflip"):
        assert lc["quarantined"]
        assert all("quarantined" in why for why in lc["quarantined"].values())
        assert any(k == "head" or k.startswith("quarantine:")
                   for k in rep["fallbacks"])
        assert lc["audit"]["integrity_scans"] > 0


def test_combined_chaos_gemma():
    """The whole chaos schedule on gemma3-4b (sliding windows): every
    request DONE with the clean run's tokens, as in the reference."""
    kw = dict(arch="gemma3-4b", **FULL)
    _, base = _run(_engine("pt", **kw))
    eng = _engine("pt", audit=True, faults=FaultPlan.chaos(seed=3,
                                                           horizon=24), **kw)
    rep, toks = _run(eng)
    ref_rep, ref_toks = _run(_engine("ref", audit=True,
                                     faults=RefPlan.chaos(seed=3,
                                                          horizon=24), **kw))
    assert rep["lifecycle"]["faults"]["fired"] >= 3
    assert rep["lifecycle"]["faults"] == ref_rep["lifecycle"]["faults"]
    assert toks == base == ref_toks
    _assert_clean(eng)


def test_audit_off_nan_serves_other_tokens(clean):
    """Without the auditor the NaN head is served: other tokens."""
    kw = dict(paged=True, page_len=8, prefill_chunk=4)
    _, base = _run(_engine("pt", **kw))
    _, toks = _run(_engine("pt", faults=FaultPlan(seed=7).nan_logits(step=3),
                           **kw))
    assert toks != base


def test_bitflip_quarantine_lands_in_manifest():
    plan = FaultPlan(seed=2).bitflip(step=4, field="bitmap")
    eng = _engine("pt", audit=True, faults=plan, paged=True, page_len=8,
                  prefill_chunk=4)
    rep, _ = _run(eng)
    [(path, reason)] = list(rep["lifecycle"]["quarantined"].items())
    assert path != "lm_head"
    entry = next(e for e in eng.packed.manifest if e.path == path)
    assert not entry.packed and "quarantined" in entry.reason
    assert entry.layout == "dense" and entry.block is None
    assert entry.sparse_bytes == entry.dense_bytes
    _, b, c, n = path.split("/")
    assert eng.packed.blocks[b][c][n] is None
    assert rep["weight_stream"]["fallbacks"][path] == reason
    assert path not in eng.auditor._sums


def test_quarantined_head_is_served_as_packed():
    """A quarantined head is served from the params' head as it stands,
    as the reference serves it (``lm_weight = None``): the step's dense
    head is ``lm_head_weight(params)``, not a re-pruned copy."""
    from repro_torch.models.model import head_logits, lm_head_weight
    eng = _engine("pt", audit=True,
                  faults=FaultPlan(seed=1).nan_logits(step=2),
                  paged=True, page_len=8)
    _run(eng)
    assert eng.lm_weight is None and "lm_head" in eng.quarantined
    assert not hasattr(eng, "_head_dense")
    h = torch.randn(3, eng.cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    torch.testing.assert_close(head_logits(eng.params, eng.cfg, h),
                               h @ lm_head_weight(eng.params, eng.cfg),
                               rtol=0, atol=0)


def _flip_head_bit(eng, field: str, bit: int) -> None:
    """Flip one bit of the packed LM head's values or bitmap (either
    engine's: a host copy, back into the engine's array type)."""
    bw = eng.lm_weight
    name = "values" if field == "values" else "packed_bits"
    arr = getattr(bw, name)
    host = np.array(arr).copy()
    flat = host.view(np.uint8).reshape(-1)
    flat[bit // 8 % flat.size] ^= np.uint8(1 << (bit % 8))
    new = (torch.from_numpy(host) if isinstance(arr, torch.Tensor)
           else jax.numpy.asarray(host))
    eng.lm_weight = dataclasses.replace(bw, **{name: new})


@pytest.mark.parametrize("field", ["values", "bitmap"])
def test_head_bitflip_serves_reference_tokens(field):
    """A bit of the packed LM head flipped at a seeded step (the same
    bit in both engines): the auditor quarantines ``lm_head``, every
    in-flight request replays through the params' head, and the tokens
    equal the reference engine's (sampled requests included), and so do
    the logits of every step after the quarantine (the params' head, not
    a re-pruned one)."""
    bit = int(np.random.default_rng(5).integers(1 << 16))
    toks, quarantined, logits = {}, {}, {}
    for side in ("ref", "pt"):
        eng = _engine(side, audit=True, paged=True, page_len=8)
        reqs = [eng.submit(p, 6, arrival=float(i),
                           temperature=(0.9 if i % 2 else 0.0),
                           seed=70 + i)
                for i, p in enumerate(PROMPTS)]
        logits[side] = rows = []
        decode = eng._decode

        def recording(*args, decode=decode, eng=eng, rows=rows):
            out = decode(*args)
            if "lm_head" in eng.quarantined:
                rows.append(np.array(out[1], np.float32))
            return out

        eng._decode = recording
        eng.warmup()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            while eng.scheduler.has_work:
                if eng._steps == 3 and "lm_head" not in eng.quarantined:
                    _flip_head_bit(eng, field, bit)
                eng.step()
        toks[side] = [[int(t) for t in r.tokens] for r in reqs]
        quarantined[side] = dict(eng.quarantined)
    assert list(quarantined["pt"]) == ["lm_head"]
    assert quarantined["pt"] == quarantined["ref"]
    assert toks["pt"] == toks["ref"]
    assert len(logits["pt"]) == len(logits["ref"]) > 0
    for got, want in zip(logits["pt"], logits["ref"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sparsity", [0.0, 0.75])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(paged=True, page_len=8),
    dict(paged=True, page_len=8, prefix_reuse=True),
    FULL,
], ids=["contig", "paged", "reuse", "reuse+preempt"])
def test_audit_mode_is_bit_identical(kw, sparsity):
    _, base = _run(_engine("pt", sparsity=sparsity, **kw))
    eng = _engine("pt", sparsity=sparsity, audit=True, **kw)
    rep, toks = _run(eng)
    assert toks == base
    au = rep["lifecycle"]["audit"]
    assert au["enabled"] and au["steps_checked"] > 0
    _assert_clean(eng)


def test_force_preempt_on_contiguous_engine():
    """A forced preemption of a contiguous engine re-ingests by the
    prompt walk and serves the same tokens (the reference's guard)."""
    _, base = _run(_engine("pt"))
    eng = _engine("pt", audit=True,
                  faults=FaultPlan(seed=0).force_preempt(step=3, count=2))
    rep, toks = _run(eng)
    assert rep["lifecycle"]["forced_preempts"] == 2
    assert toks == base

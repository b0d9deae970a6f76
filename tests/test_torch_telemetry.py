"""Port's serving telemetry against the JAX package's: the metrics
registry, the serving clock and the artifact validators as units; the
engine's ``report()`` with the reference's keys, order and value types
over the reference's knob matrix, packed and dense; the same registry
names; and the same tokens with telemetry on and off.
"""
import dataclasses
import json
import pathlib
import time
import warnings

import numpy as np
import pytest

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as ref_M
from repro.serve import ServeEngine as RefEngine
from repro.serve import telemetry as ref_tel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.serve import (Clock, MetricsRegistry, load_trace,
                               poisson_trace, validate_events,
                               validate_trace)
from repro_torch.serve import ServeEngine as PtEngine
from repro_torch.serve.telemetry import EVENT_KINDS, PHASES, validate_event

CFG = dataclasses.replace(ref_smoke("olmo-1b"), compute_dtype="float32")
PCFG = dataclasses.replace(pt_smoke("olmo-1b"), compute_dtype="float32")

# the reference's schema-snapshot knob sets (tests/test_telemetry.py)
KNOBS = [
    {},
    {"paged": True, "page_len": 8},
    {"paged": True, "page_len": 8, "prefill_chunk": 8,
     "prefix_reuse": True},
    {"paged": True, "page_len": 8, "preempt": True},
    {"audit": True},
]


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray,
                        ref_M.init_params(jax.random.PRNGKey(0), CFG))


def _engine(side, params, **kw):
    kw = {"num_slots": 2, "max_len": 32, "sparsity": 0.5, "seed": 0, **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # fallback warnings
        if side == "ref":
            eng = RefEngine(CFG, **kw)
            # the same values as host arrays, without the mesh's
            # NamedSharding: this JAX's sharding-in-types cannot resolve
            # the dense-dispatch KV scatter's output sharding on one CPU
            eng.params = jax.tree.map(np.asarray, eng.params)
            return eng
        return PtEngine(PCFG, params=params_from_numpy(params, device="cpu"),
                        device="cpu", **kw)


def _run(eng, requests=3, seed=0):
    trace = poisson_trace(requests, rate=0.5, seed=seed,
                          vocab_size=CFG.vocab_size, prompt_len=(1, 4),
                          max_new=(2, 5))
    for spec in trace:
        eng.submit(**spec)
    rep = eng.run()
    return rep, [(r.rid, r.state.name, list(r.tokens)) for r in eng.requests]


def _kind(v):
    """A value's type as a JSON reader sees it."""
    if v is None or isinstance(v, (bool, str)):
        return type(v).__name__ if v is not None else "None"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    if isinstance(v, (list, tuple)):
        return "list"
    assert isinstance(v, dict), type(v)
    return "dict"


def _shape(v):
    """Keys in order and value kinds, recursively."""
    if isinstance(v, dict):
        return [(k, _shape(x)) for k, x in v.items()]
    if isinstance(v, (list, tuple)):
        return ["list", [_shape(x) for x in v]]
    return _kind(v)


# ------------------------------------------------------- registry units ----


def test_counter_gauge_histogram():
    reg = MetricsRegistry()
    c = reg.counter("c", help="a counter")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(AssertionError):
        c.inc(-1)
    g = reg.gauge("g")
    g.set(7)
    assert g.value == 7
    backing = {"v": 1}
    gf = reg.gauge("gf", lambda: backing["v"])
    backing["v"] = 42
    assert gf.value == 42
    with pytest.raises(AssertionError):
        gf.set(0)
    h = reg.histogram("h", seed=3)
    for v in (1.0, 2.0, 3.0):
        h.observe(v)
    assert h.count == 3 and h.sum == pytest.approx(6.0)
    assert h.mean == pytest.approx(2.0)
    assert h.percentiles()["p50"] == pytest.approx(2.0)
    with pytest.raises(AssertionError):
        reg.counter("c")
    assert reg.names == ["c", "g", "gf", "h"]


def test_views_render_in_order_and_snapshot_is_strict_json(tmp_path):
    reg = MetricsRegistry()
    reg.view("b", lambda: 2)
    reg.view("a", lambda: {"nested": 1})
    assert list(reg.render()) == ["b", "a"]
    with pytest.raises(AssertionError):
        reg.view("b", lambda: 0)
    reg.counter("c").inc(2)
    reg.gauge("reason", lambda: "because")
    reg.histogram("empty")
    snap = reg.snapshot()
    assert snap["c"] == 2 and snap["reason"] == "because"
    assert snap["empty"]["mean"] is None
    json.dumps(snap, allow_nan=False)
    p = tmp_path / "m.json"
    reg.write(str(p))
    doc = json.loads(p.read_text())
    assert doc["schema"] == "repro.serve.metrics/v1"
    assert doc["metrics"]["c"] == 2


def test_prometheus_text_equals_reference(tmp_path):
    pages = []
    for mod in (ref_tel, None):
        reg = (mod.MetricsRegistry() if mod is not None
               else MetricsRegistry())
        reg.counter("tokens.generated", help="tokens").inc(9)
        reg.gauge("queue.depth", lambda: 3)
        reg.gauge("fallback.reason", lambda: "strings are skipped")
        h = reg.histogram("step.wall_s", seed=5)
        for v in (0.25, 0.5, 0.125):
            h.observe(v)
        pages.append(reg.to_prometheus())
    assert pages[1] == pages[0]
    assert "repro_serve_tokens_generated 9" in pages[1]
    assert "strings are skipped" not in pages[1]
    p = tmp_path / "m.prom"
    reg.write(str(p))
    assert p.read_text() == pages[1]


def test_clock_starts_once():
    clk = Clock()
    assert not clk.started and clk.now_or_zero() == 0.0
    clk.start()
    t0 = clk.t0
    time.sleep(0.01)
    clk.start()
    assert clk.t0 == t0 and clk.now() >= 0.01
    assert clk.rel(t0 + 1.0) == pytest.approx(1.0)


def test_warmup_never_leaks_into_wall(params):
    """Host time between warmup and serving (here a 0.3 s sleep) never
    lands in ``wall_s``: the clock starts inside ``run``, so the wall it
    reports fits inside the time ``run`` itself took."""
    eng = _engine("pt", params)
    eng.warmup()
    time.sleep(0.3)
    assert not eng._clock.started
    eng.submit([1, 2, 3], max_new_tokens=2)
    t0 = time.perf_counter()
    rep = eng.run()
    inside_run = time.perf_counter() - t0
    assert eng._clock.started and 0 < rep["wall_s"] <= inside_run


def test_validators():
    validate_event({"t": 0.0, "step": 0, "kind": "done", "rid": 1})
    with pytest.raises(ValueError):
        validate_event({"t": 0.0, "step": 0, "kind": "nope"})
    with pytest.raises(ValueError):
        validate_event({"step": 0, "kind": "done"})
    with pytest.raises(ValueError):
        validate_event({"t": 0.0, "step": -1, "kind": "done"})
    assert EVENT_KINDS == ref_tel.EVENT_KINDS and PHASES == ref_tel.PHASES
    step = {"ph": "X", "cat": "step", "name": "step", "ts": 0.0,
            "dur": 100.0, "tid": 0}
    inside = {"ph": "X", "cat": "phase", "name": "decode", "ts": 10.0,
              "dur": 50.0, "tid": 0}
    stats = validate_trace([step, inside])
    assert stats["steps"] == 1 and stats["agg_coverage"] == 0.5
    with pytest.raises(ValueError):
        validate_trace([step, dict(inside, ts=200.0)])     # in no step
    with pytest.raises(ValueError):
        validate_trace([step, inside, dict(inside, ts=30.0)])  # overlap


# -------------------------------------------------------- schema parity ----


@pytest.mark.parametrize("stream", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("knobs", KNOBS,
                         ids=["plain", "paged", "prefix", "preempt",
                              "audit"])
def test_report_keys_order_types_equal_reference(params, knobs, stream):
    """``report()`` has the reference's keys, in its order, with its
    value types, everywhere below the top level too; the registry holds
    the reference's metric names in the reference's order; and the
    counts no wall clock decides are equal."""
    reps, served, names = {}, {}, {}
    for side in ("ref", "pt"):
        eng = _engine(side, params, stream_weights=stream,
                      bitmap_head=stream, **knobs)
        reps[side], served[side] = _run(eng, requests=2)
        names[side] = eng.metrics.names
    assert _shape(reps["pt"]) == _shape(reps["ref"])
    assert names["pt"] == names["ref"]
    assert served["pt"] == served["ref"]
    for key in ("requests", "generated_tokens", "steps", "slot_occupancy",
                "prefill", "weight_stream", "paging", "cache_resets",
                "fallbacks"):
        assert reps["pt"][key] == reps["ref"][key], key
    if knobs.get("audit"):
        assert reps["pt"]["lifecycle"]["audit"] == \
            reps["ref"]["lifecycle"]["audit"]


# ------------------------------------------------------------ off == on ----


def test_telemetry_off_is_none_and_identical(params, tmp_path):
    knobs = dict(paged=True, page_len=8, prefill_chunk=8, prefix_reuse=True,
                 audit=True)
    off = _engine("pt", params, **knobs)
    assert off.telemetry is None and off.spans is None and off.events is None
    _, served_off = _run(off, requests=4)
    assert off.close() == []

    on = _engine("pt", params, trace_out=str(tmp_path / "t.json"),
                 events_out=str(tmp_path / "e.jsonl"),
                 metrics_out=str(tmp_path / "m.json"), **knobs)
    _, served_on = _run(on, requests=4)
    assert served_on == served_off
    paths = on.close()
    assert [pathlib.Path(p).name for p in paths] == \
        ["t.json", "e.jsonl", "m.json"]
    assert on.close() == []
    stats = validate_trace(str(tmp_path / "t.json"))
    assert stats["steps"] > 0 and stats["requests"] == 4
    assert stats["agg_coverage"] > 0.5
    assert validate_events(str(tmp_path / "e.jsonl")) > 0
    doc = json.loads((tmp_path / "m.json").read_text())
    assert doc["metrics"]["steps.decode"] == on.decode_steps > 0


def test_trace_spans_phases_and_event_log(params, tmp_path):
    eng = _engine("pt", params, prefill_chunk=8, deadline_ms=1e9,
                  trace_out=str(tmp_path / "t.json"),
                  events_out=str(tmp_path / "e.jsonl"))
    _run(eng, requests=3)
    eng.close()
    events = load_trace(str(tmp_path / "t.json"))
    names = {e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "phase"}
    assert names <= set(PHASES)
    assert {"schedule", "decode", "sample", "host_sync",
            "deadline_sweep"} <= names
    req_names = {e["name"] for e in events
                 if e.get("ph") == "X" and e.get("cat") == "request"}
    assert req_names <= {"QUEUED", "PREFILL", "DECODE"}
    h = eng.metrics.get("step.wall_s")
    assert h.count == eng.spans.steps > 0
    assert eng.metrics.get("step.phase_coverage").mean > 0.5
    kinds = set()
    with open(tmp_path / "e.jsonl") as f:
        for line in f:
            kinds.add(json.loads(line)["kind"])
    assert {"submit", "admit", "prefill_done", "first_token",
            "done"} <= kinds <= EVENT_KINDS


def test_cli_flags_write_every_artifact(tmp_path, capsys):
    """The CLI's lifecycle, fault and telemetry flags, as the reference's
    CLI takes them: the chaos plan fires under the auditor and every
    artifact is written and valid."""
    from repro_torch.launch.serve import main
    out = {name: str(tmp_path / name) for name in
           ("trace.json", "events.jsonl", "metrics.prom", "traffic.json")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # quarantine warnings
        main(["--arch", "olmo-1b", "--smoke", "--sparsity", "0.5",
              "--device", "cpu", "--paged", "--page-len", "8",
              "--prefix-reuse", "--preempt", "--prefill-chunk", "4",
              "--chaos-seed", "3", "--deadline-ms", "600000",
              "--max-queue", "16", "--trace-out", out["trace.json"],
              "--events-out", out["events.jsonl"],
              "--metrics-out", out["metrics.prom"],
              "--traffic-out", out["traffic.json"]])
    text = capsys.readouterr().out
    for path in out.values():
        assert f"telemetry written: {path}" in text
    assert "fault injection: 5/5 faults fired (seed 3)" in text
    assert "quarantined tensors:" in text and "audit:" in text
    assert "crosscheck (xla-oracle): " in text
    assert validate_trace(out["trace.json"])["steps"] > 0
    assert validate_events(out["events.jsonl"]) > 0
    assert "repro_serve_steps_decode" in open(out["metrics.prom"]).read()
    doc = json.loads(open(out["traffic.json"]).read())
    assert doc["schema"] == "repro.serve.traffic/v1"

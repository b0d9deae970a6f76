"""Serving telemetry: one metrics registry, phase-timed step spans, and
a structured event log.

The paper's headline claims are *traffic* claims (EIM/SIDR cut SRAM
access 86 % vs SparTen), and EIE-style designs live or die on
per-component access counts made visible, not inferred — so the serving
engine's observability is a subsystem, not an afterthought.  Three
layers, all optional and all off by default:

* **Metrics registry** (`MetricsRegistry`): typed ``Counter`` /
  ``Gauge`` / ``Histogram`` metrics (histograms reuse the seeded
  ``RollingStat`` reservoir, so percentiles stay deterministic per
  trace) that every subsystem — engine, scheduler, paging, prefill
  planner, packed stream, faults/audit — registers into.  The engine's
  ``report()`` is a *rendered snapshot* of this one registry: named
  ``view`` entries reproduce the legacy section/field layout
  byte-for-byte (schema pinned by test), while the flat metrics export
  as a Prometheus text page (``to_prometheus()``) or a JSON snapshot
  (``--metrics-out``).

* **Step-phase spans** (`StepSpans`): monotonic-clock brackets around
  the host-side phases of ``ServeEngine.step`` — schedule /
  deadline-sweep / page-ensure / prefill / decode / host-sync / sample
  / audit — accumulated into per-phase histograms and, when
  ``--trace-out`` is set, emitted as Chrome trace-event JSON
  (perfetto-viewable) together with per-request lifecycle spans
  (QUEUED → PREFILL → DECODE) and instant markers for preemptions,
  faults and quarantines.  Spans bracket only host-side code; device
  time surfaces in the ``host_sync`` phase (the step's one existing
  copy of its tokens to the host), so enabling tracing adds no host
  transfers and no extra synchronization.

* **Event log** (`EventLog`): one JSONL schema unifying lifecycle
  transitions, fallback warnings, fault injections and audit
  violations — every record carries a monotonic timestamp, the engine
  step, a ``kind`` from ``EVENT_KINDS`` and (where applicable) the
  rid, so "what happened to request 1234" is one grep.

Telemetry-off is the default and is bit-identical and allocation-free
on the hot path: the engine holds ``spans is None`` / ``events is
None`` and every bracket is a plain ``is not None`` check — no span
objects, no context managers, no host transfers (asserted by test).

``Clock`` is the serving wall clock: started exactly once, *after*
warmup, through one idempotent ``start()``, so the kernel library's
build can never leak into the first timed step.  It reads the host
clock only: every wall read on the engine's path already follows a
device sync (the decode step's tokens copied to the host, or the sync
after a prefill call), so a sync inside ``Clock`` would add one per
read and measure nothing new.

A copy of ``repro/serve/telemetry.py`` with the imports rewritten.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Union

from repro_torch.serve.trace import RollingStat

__all__ = [
    "Clock", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "ChromeTrace", "StepSpans", "EventLog", "Telemetry", "PHASES",
    "EVENT_KINDS", "load_trace", "validate_trace", "validate_event",
    "validate_events",
]


# ---------------------------------------------------------------- clock ----

class Clock:
    """The serving wall clock: monotonic (``time.perf_counter``),
    started exactly once via the idempotent ``start()``.

    The engine calls ``start()`` *after* ``warmup()`` in both ``step``
    and ``run``, so no call path can start the clock while the kernel
    library is still being built (a test pins this).
    """

    def __init__(self) -> None:
        self._t0: Optional[float] = None

    @property
    def started(self) -> bool:
        return self._t0 is not None

    @property
    def t0(self) -> Optional[float]:
        return self._t0

    def start(self) -> None:
        """Start the clock; later calls are no-ops."""
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def now(self) -> float:
        """Seconds since ``start()``; raises if never started."""
        assert self._t0 is not None, "Clock.now() before start()"
        return time.perf_counter() - self._t0

    def now_or_zero(self) -> float:
        """``now()``, or 0.0 before the clock starts (pre-run events)."""
        return time.perf_counter() - self._t0 if self._t0 is not None \
            else 0.0

    def rel(self, t_abs: float) -> float:
        """Convert an absolute ``perf_counter`` stamp to clock time."""
        assert self._t0 is not None
        return t_abs - self._t0


# -------------------------------------------------------------- metrics ----

class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        assert n >= 0, f"counter {self.name} decremented by {n}"
        self.value += n


class Gauge:
    """Point-in-time value: either set explicitly (``set``) or computed
    at snapshot time from a callback (``fn``) — subsystems register
    callback gauges over their live state so the registry never holds a
    stale copy.  Values may be non-numeric (fallback-reason strings,
    None); those appear in the JSON snapshot and are skipped by the
    Prometheus exporter."""

    kind = "gauge"

    def __init__(self, name: str, fn: Optional[Callable] = None,
                 help: str = ""):
        self.name = name
        self.help = help
        self._fn = fn
        self._value = None

    def set(self, v) -> None:
        assert self._fn is None, f"gauge {self.name} is callback-backed"
        self._value = v

    @property
    def value(self):
        return self._fn() if self._fn is not None else self._value


class Histogram:
    """Distribution metric over the seeded ``RollingStat`` reservoir:
    exact count/sum/mean, deterministic p50/p99 (exact below the
    reservoir cap — identical to a full scan on short traces)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", cap: int = 2048,
                 seed: int = 0):
        self.name = name
        self.help = help
        self.stat = RollingStat(cap=cap, seed=seed)

    def observe(self, v) -> None:
        self.stat.add(v)

    @property
    def count(self) -> int:
        return self.stat.count

    @property
    def sum(self) -> float:
        return self.stat.total

    @property
    def mean(self) -> float:
        return self.stat.mean

    def percentiles(self, qs=(50, 99)) -> Dict[str, float]:
        return self.stat.percentiles(qs)


def _nan_to_none(v):
    return None if isinstance(v, float) and math.isnan(v) else v


def prom_name(name: str, prefix: str = "repro_serve_") -> str:
    """Sanitize a dotted metric name into Prometheus form."""
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return prefix + out


class MetricsRegistry:
    """The one place metrics live.

    Two faces:

    * flat typed metrics (``counter`` / ``gauge`` / ``histogram``),
      snapshot-exported as JSON (``snapshot``/``write``) or a
      Prometheus text page (``to_prometheus``);
    * named ``view`` entries — callables evaluated at render time —
      whose insertion-ordered evaluation *is* the engine's
      ``report()`` dict, so the legacy report schema is a rendered
      projection of the registry rather than a second bookkeeping
      system.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}
        self._views: Dict[str, Callable[[], object]] = {}

    # ---- registration -------------------------------------------------

    def _add(self, metric):
        assert metric.name not in self._metrics, \
            f"duplicate metric {metric.name}"
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._add(Counter(name, help))

    def gauge(self, name: str, fn: Optional[Callable] = None,
              help: str = "") -> Gauge:
        return self._add(Gauge(name, fn, help))

    def histogram(self, name: str, help: str = "", cap: int = 2048,
                  seed: int = 0) -> Histogram:
        return self._add(Histogram(name, help, cap=cap, seed=seed))

    def view(self, name: str, fn: Callable[[], object]) -> None:
        """Register a top-level ``report()`` entry (scalar or section)."""
        assert name not in self._views, f"duplicate view {name}"
        self._views[name] = fn

    def get(self, name: str):
        return self._metrics[name]

    @property
    def names(self) -> List[str]:
        return list(self._metrics)

    # ---- rendering ----------------------------------------------------

    def render(self) -> Dict:
        """Evaluate every view in registration order — the report."""
        return {name: fn() for name, fn in self._views.items()}

    def snapshot(self) -> Dict:
        """Flat ``{name: value}`` snapshot of every metric.  Histograms
        render as ``{count, sum, mean, p50, p99}``; NaN (empty
        histogram) becomes None so the snapshot is strict JSON."""
        out: Dict[str, object] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                pct = m.percentiles()
                out[name] = {
                    "count": m.count, "sum": m.sum,
                    "mean": _nan_to_none(m.mean),
                    "p50": _nan_to_none(pct["p50"]),
                    "p99": _nan_to_none(pct["p99"]),
                }
            else:
                out[name] = _nan_to_none(m.value)
        return out

    def to_prometheus(self, prefix: str = "repro_serve_") -> str:
        """Prometheus text exposition (0.0.4).  Counters and numeric
        gauges export directly; histograms export as summaries
        (quantile-labelled samples + ``_sum``/``_count``); non-numeric
        gauges (reason strings, None) are skipped — they live in the
        JSON snapshot and the rendered report."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            pname = prom_name(name, prefix)
            if isinstance(m, Histogram):
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} summary")
                pct = m.percentiles()
                for q, key in ((0.5, "p50"), (0.99, "p99")):
                    v = pct[key]
                    if not math.isnan(v):
                        lines.append(f'{pname}{{quantile="{q}"}} {v}')
                lines.append(f"{pname}_sum {m.sum}")
                lines.append(f"{pname}_count {m.count}")
                continue
            v = m.value
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, (int, float)):
                continue
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            lines.append(f"{pname} {v}")
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        """Write the snapshot: Prometheus text for ``.prom`` paths,
        strict JSON otherwise."""
        if path.endswith(".prom"):
            with open(path, "w") as f:
                f.write(self.to_prometheus())
            return
        with open(path, "w") as f:
            json.dump({"schema": "repro.serve.metrics/v1",
                       "metrics": self.snapshot()}, f, indent=2,
                      allow_nan=False)


# --------------------------------------------------------- chrome trace ----

#: pid/tid layout of the exported trace: engine step + phase spans on
#: one track, each request's lifecycle on its own thread of a second
#: process (perfetto renders them as one row per rid).
PID_ENGINE, TID_STEP = 1, 0
PID_REQUESTS = 2


class ChromeTrace:
    """Chrome trace-event JSON accumulator (perfetto / chrome://tracing
    loadable).  Timestamps are serving-clock seconds converted to the
    format's microseconds; events buffer in memory and ``write()`` dumps
    the standard ``{"traceEvents": [...]}`` envelope."""

    def __init__(self) -> None:
        self.events: List[Dict] = []
        self._named_threads: set = set()
        self._meta(PID_ENGINE, None, "serve_engine")
        self._meta(PID_ENGINE, TID_STEP, "step")
        self._meta(PID_REQUESTS, None, "requests")

    def _meta(self, pid: int, tid: Optional[int], name: str) -> None:
        if tid is None:
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid, "tid": 0,
                                "args": {"name": name}})
        else:
            self.events.append({"ph": "M", "name": "thread_name",
                                "pid": pid, "tid": tid,
                                "args": {"name": name}})

    def ensure_thread(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) not in self._named_threads:
            self._named_threads.add((pid, tid))
            self._meta(pid, tid, name)

    def complete(self, name: str, t0_s: float, dur_s: float, *,
                 pid: int = PID_ENGINE, tid: int = TID_STEP,
                 cat: str = "phase",
                 args: Optional[Dict] = None) -> None:
        ev = {"ph": "X", "name": name, "cat": cat,
              "ts": t0_s * 1e6, "dur": max(dur_s, 0.0) * 1e6,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, t_s: float, values: Dict[str, float], *,
                pid: int = PID_ENGINE, tid: int = TID_STEP,
                cat: str = "traffic") -> None:
        """One counter-track sample (ph "C"): perfetto renders each
        ``values`` key as a stacked series under ``name`` — the per-phase
        HBM byte tracks."""
        self.events.append({"ph": "C", "name": name, "cat": cat,
                            "ts": t_s * 1e6, "pid": pid, "tid": tid,
                            "args": dict(values)})

    def instant(self, name: str, t_s: float, *, pid: int = PID_ENGINE,
                tid: int = TID_STEP, cat: str = "marker",
                args: Optional[Dict] = None) -> None:
        ev = {"ph": "i", "name": name, "cat": cat, "ts": t_s * 1e6,
              "s": "t", "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events,
                       "displayTimeUnit": "ms"}, f)


def load_trace(path: str) -> List[Dict]:
    with open(path) as f:
        data = json.load(f)
    assert isinstance(data, dict) and "traceEvents" in data, \
        f"{path}: not a Chrome trace-event file"
    return data["traceEvents"]


def validate_trace(events_or_path) -> Dict:
    """Structural validation of an exported trace (the CI smoke's
    contract):

    * every phase span nests inside exactly one step span (no phase
      leaks across a step boundary), and phases within a step do not
      overlap one another;
    * per step, the phase durations sum to at most the step duration,
      and the coverage fraction is reported (the smoke asserts >= 95 %:
      the phase taxonomy accounts for where step wall time goes);
    * request spans (QUEUED/PREFILL/DECODE per tid) appear in lifecycle
      order.

    Returns summary stats; raises ``ValueError`` on violation.
    """
    events = (load_trace(events_or_path)
              if isinstance(events_or_path, str) else events_or_path)
    eps = 5.0  # us of float slack on span edges
    steps = sorted((e for e in events
                    if e.get("ph") == "X" and e.get("cat") == "step"),
                   key=lambda e: e["ts"])
    phases = [e for e in events
              if e.get("ph") == "X" and e.get("cat") == "phase"]
    by_step: Dict[int, List[Dict]] = {i: [] for i in range(len(steps))}
    for p in phases:
        host = None
        for i, s in enumerate(steps):
            if (s["ts"] - eps <= p["ts"]
                    and p["ts"] + p["dur"] <= s["ts"] + s["dur"] + eps):
                host = i
                break
        if host is None:
            raise ValueError(
                f"phase span {p['name']} at ts={p['ts']:.1f}us nests in "
                f"no step span")
        by_step[host].append(p)
    coverage = []
    phase_us = step_us = 0.0
    for i, s in enumerate(steps):
        ph = sorted(by_step[i], key=lambda e: e["ts"])
        for a, b in zip(ph, ph[1:]):
            if a["ts"] + a["dur"] > b["ts"] + eps:
                raise ValueError(
                    f"phases {a['name']} and {b['name']} overlap inside "
                    f"step {i}")
        total = sum(p["dur"] for p in ph)
        if s["dur"] > 0:
            if total > s["dur"] + eps * max(1, len(ph)):
                raise ValueError(
                    f"step {i}: phase durations sum past the step wall "
                    f"({total:.1f}us > {s['dur']:.1f}us)")
            coverage.append(total / s["dur"])
            phase_us += total
            step_us += s["dur"]
    order = {"QUEUED": 0, "PREFILL": 1, "DECODE": 2}
    req_spans: Dict[int, List[Dict]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "request":
            req_spans.setdefault(e["tid"], []).append(e)
    for tid, spans in req_spans.items():
        spans.sort(key=lambda e: (e["ts"], order.get(e["name"], 9)))
        ranks = [order.get(e["name"], -1) for e in spans]
        if -1 in ranks or ranks != sorted(ranks):
            raise ValueError(
                f"request tid={tid}: lifecycle spans out of order: "
                f"{[e['name'] for e in spans]}")
    return {
        "steps": len(steps),
        "phase_spans": len(phases),
        "requests": len(req_spans),
        "min_coverage": min(coverage) if coverage else None,
        "mean_coverage": (sum(coverage) / len(coverage)
                          if coverage else None),
        # duration-weighted: a scheduler hiccup between brackets in one
        # microsecond-scale step can crater min_coverage without the
        # taxonomy actually leaking time — this is the 5 % criterion
        "agg_coverage": phase_us / step_us if step_us else None,
    }


# ----------------------------------------------------------- step spans ----

#: The step-phase taxonomy (DESIGN_SERVING.md §Observability).  Phases
#: are sequential and non-overlapping inside one step; together they
#: cover (nearly) the whole host-side step wall, so their histograms
#: answer "where does a step's time go".
PHASES = ("schedule", "prefill", "page_ensure", "decode", "host_sync",
          "sample", "deadline_sweep", "audit")

_PHASE_SEEDS = {p: 0x7e1e + i for i, p in enumerate(PHASES)}


class StepSpans:
    """Phase-timed spans around ``ServeEngine.step``'s host-side code.

    ``begin(name)`` / ``end()`` bracket one phase at a time (phases
    never nest — the step span is the only parent); each bracket costs
    two ``perf_counter`` reads and one histogram observe.  With a
    ``ChromeTrace`` attached, every phase and step also emits a
    complete event on the engine track.
    """

    def __init__(self, registry: MetricsRegistry, clock: Clock,
                 trace: Optional[ChromeTrace] = None):
        self.clock = clock
        self.trace = trace
        self.h_phase = {
            p: registry.histogram(
                f"step.phase.{p}_s", seed=_PHASE_SEEDS[p],
                help=f"host-side seconds in the {p} phase per step")
            for p in PHASES}
        self.h_step = registry.histogram(
            "step.wall_s", seed=0x57e9,
            help="host-side wall seconds per engine step")
        self.h_coverage = registry.histogram(
            "step.phase_coverage", seed=0xc04e,
            help="fraction of the step wall covered by phase spans")
        self.steps = 0
        self._t_step: Optional[float] = None
        self._step_idx = 0
        self._acc = 0.0
        self._t_phase: Optional[float] = None
        self._phase: Optional[str] = None

    def step_begin(self, step: int, t_abs: Optional[float] = None) -> None:
        self._t_step = time.perf_counter() if t_abs is None else t_abs
        self._step_idx = step
        self._acc = 0.0

    def begin(self, name: str) -> None:
        assert self._phase is None, \
            f"phase {name} opened inside {self._phase}"
        self._phase = name
        self._t_phase = time.perf_counter()

    def end(self) -> None:
        t1 = time.perf_counter()
        name, t0 = self._phase, self._t_phase
        assert name is not None, "StepSpans.end() with no open phase"
        self._phase = None
        dt = t1 - t0
        self._acc += dt
        self.h_phase[name].observe(dt)
        if self.trace is not None:
            self.trace.complete(name, self.clock.rel(t0), dt,
                                cat="phase")

    def step_end(self) -> None:
        assert self._phase is None, \
            f"step ended with phase {self._phase} still open"
        t1 = time.perf_counter()
        dur = t1 - self._t_step
        self.h_step.observe(dur)
        self.h_coverage.observe(self._acc / dur if dur > 0 else 1.0)
        self.steps += 1
        if self.trace is not None:
            self.trace.complete("step", self.clock.rel(self._t_step),
                                dur, cat="step",
                                args={"step": self._step_idx})


# ------------------------------------------------------------ event log ----

#: The unified event schema's ``kind`` vocabulary: request lifecycle
#: transitions, the fallback/fault/quarantine surface, and audit
#: violations — one stream, one set of field names.
EVENT_KINDS = frozenset({
    "submit", "admit", "prefill_done", "first_token", "preempt",
    "done", "cancelled", "expired", "shed", "fallback", "fault",
    "quarantine", "audit_violation",
})

_REQUIRED = ("t", "step", "kind")


def validate_event(rec: Dict) -> None:
    """Raise ``ValueError`` unless ``rec`` matches the event schema:
    ``t`` (float seconds, monotonic per log), ``step`` (int >= 0),
    ``kind`` (one of ``EVENT_KINDS``), ``rid`` (int or None), and
    JSON-scalar extras."""
    for key in _REQUIRED:
        if key not in rec:
            raise ValueError(f"event missing required field {key!r}: "
                             f"{rec}")
    if not isinstance(rec["t"], (int, float)) or rec["t"] < 0:
        raise ValueError(f"event t must be a non-negative number: {rec}")
    if not isinstance(rec["step"], int) or rec["step"] < 0:
        raise ValueError(f"event step must be a non-negative int: {rec}")
    if rec["kind"] not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {rec['kind']!r}: {rec}")
    rid = rec.get("rid")
    if rid is not None and not isinstance(rid, int):
        raise ValueError(f"event rid must be int or None: {rec}")


def validate_events(path: str) -> int:
    """Validate a JSONL event file: every line parses, matches the
    schema, and timestamps are monotonic.  Returns the record count."""
    last_t = -1.0
    n = 0
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}")
            validate_event(rec)
            if rec["t"] < last_t:
                raise ValueError(
                    f"{path}:{i + 1}: timestamp went backwards "
                    f"({rec['t']} < {last_t})")
            last_t = rec["t"]
            n += 1
    return n


class EventLog:
    """Structured JSONL event log.  Records buffer in memory (bounded
    by ``cap``: the oldest records drop first, with a counter so the
    truncation is visible) and ``write()`` dumps one JSON object per
    line."""

    def __init__(self, cap: int = 65536):
        from collections import deque
        self.records = deque(maxlen=cap)
        self.emitted = 0
        self.dropped = 0

    def emit(self, kind: str, *, t: float, step: int,
             rid: Optional[int] = None, **fields) -> None:
        assert kind in EVENT_KINDS, f"unknown event kind {kind!r}"
        rec = {"t": t, "step": step, "kind": kind, "rid": rid}
        if fields:
            rec.update(fields)
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)
        self.emitted += 1

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec, allow_nan=False) + "\n")


# ------------------------------------------------------------ telemetry ----

class Telemetry:
    """The engine's telemetry bundle: step spans (always, when
    telemetry is on — they feed the registry's phase histograms), a
    Chrome trace accumulator when ``trace_out`` is set, and an event
    log when ``events_out`` is set.  ``close()`` writes every
    configured artifact (idempotent)."""

    def __init__(self, registry: MetricsRegistry, clock: Clock, *,
                 trace_out: Optional[str] = None,
                 events_out: Optional[str] = None,
                 metrics_out: Optional[str] = None):
        self.registry = registry
        self.clock = clock
        self.trace_out = trace_out
        self.events_out = events_out
        self.metrics_out = metrics_out
        self.trace = ChromeTrace() if trace_out else None
        self.events = EventLog() if events_out else None
        self.spans = StepSpans(registry, clock, trace=self.trace)
        self._closed = False

    def request_done(self, req) -> None:
        """Emit a retired/aborted request's lifecycle spans + instant
        markers onto its own trace thread (one perfetto row per rid)."""
        if self.trace is None:
            return
        spans, instants = req.timeline()
        if not spans and not instants:
            return
        tid = req.rid
        self.trace.ensure_thread(PID_REQUESTS, tid, f"rid {req.rid}")
        args = {"rid": req.rid, "state": req.state.name,
                "tokens": len(req.tokens)}
        if req.first_token_s is not None:
            args["first_token_ms"] = round(req.first_token_s * 1e3, 3)
        for name, t0, t1 in spans:
            self.trace.complete(name, t0, t1 - t0, pid=PID_REQUESTS,
                                tid=tid, cat="request", args=args)
        for name, t in instants:
            self.trace.instant(name, t, pid=PID_REQUESTS, tid=tid,
                               cat="request", args={"rid": req.rid})

    def close(self) -> List[str]:
        """Write every configured artifact; returns the paths written.
        Safe to call more than once (later calls are no-ops)."""
        if self._closed:
            return []
        self._closed = True
        written = []
        for path, fn in (
                (self.trace_out,
                 lambda p: self.trace.write(p)),
                (self.events_out,
                 lambda p: self.events.write(p)),
                (self.metrics_out,
                 lambda p: self.registry.write(p))):
            if path:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                fn(path)
                written.append(path)
        return written

"""The serving driver: the port's ``ServeEngine`` under a traffic mix.

Set-up makes the weights from the seed, builds the engine (which prunes
and packs them), warms up every shape the mix uses, and for a closed
loop builds the sessions' caches.  The window then drives
``ServeEngine.submit`` / ``ServeEngine.step`` on the host clock: a
closed loop steps a full batch whose freed slots take the backlog; an
open loop submits each request when it comes due and times it from
then.  Every token's time is the end of the step that produced it.

A closed loop's judged sessions are drawn from the seed before the
first step (the one with the longest cache among them); every logit row
the decode step returns for them, at each token they are served, is
kept on the device for the check.
"""
from __future__ import annotations

import gc
import inspect
import os
import time
from typing import Dict, List

import torch

from harness import manifest, profiling, traffic
from harness.stats import percentile
from harness.traffic import rng


def port_config(model: Dict):
    """The port's configuration of ``model["arch"]``, checked against the
    widths the configuration file states."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config(model["arch"]) if model.get("smoke")
           else get_config(model["arch"]))
    hd = model.get("head_dim") or model["d_model"] // model["num_heads"]
    got = {"d_model": cfg.d_model, "num_layers": cfg.num_layers,
           "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
           "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
           "num_experts": cfg.num_experts, "top_k": cfg.top_k,
           "head_dim": cfg.resolved_head_dim, "norm": cfg.norm,
           "act": cfg.act, "rope_theta": cfg.rope_theta,
           "tie_embeddings": cfg.tie_embeddings,
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype}
    want = dict(model, head_dim=hd)
    want.setdefault("num_experts", 0)
    want.setdefault("top_k", 0)
    bad = {k: (v, want[k]) for k, v in got.items() if want.get(k) != v}
    if bad:
        raise SystemExit(f"{model['arch']}: the port's config differs from "
                         f"the configuration file: {bad}")
    return cfg


# what the harness sets itself: the configuration's, the seed's, and
# where the engine writes files or plants faults
HARNESS_OPTIONS = {"sparsity", "head_sparsity", "seed", "params", "device",
                   "metrics_out", "trace_out", "events_out", "traffic_out",
                   "faults"}


def engine_options(e: Dict) -> Dict:
    """A mix's ``engine`` options, passed to ``ServeEngine`` whole; an
    option it does not take, or one the harness sets, is refused."""
    from repro_torch.serve.engine import ServeEngine
    takes = set(inspect.signature(ServeEngine.__init__).parameters)
    bad = sorted(k for k in e if k not in takes or k in HARNESS_OPTIONS
                 or k in ("self", "cfg"))
    if bad:
        raise SystemExit(f"engine options the harness does not pass to "
                         f"ServeEngine: {bad}")
    return dict(e)


class Track:
    """One request as the harness sees it."""
    __slots__ = ("spec", "h", "t_sched", "t_admit", "times")

    def __init__(self, spec, h, t_sched):
        self.spec, self.h, self.t_sched = spec, h, t_sched
        self.t_admit = None
        self.times: List[float] = []


class Serve:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model, self.mix = ctx.model, ctx.mix
        self.device = ctx.device
        self.log = profiling.CallLog()
        self.steps: List[Dict] = []
        self.profile = None
        self.judged: List[Track] = []
        self.rows: List[List] = []
        self._slots = self._last = None

    # ------------------------------------------------------------ set-up --
    def setup(self) -> None:
        from harness.weights import make_params
        from repro_torch.serve.engine import ServeEngine
        ctx, e = self.ctx, self.mix["engine"]
        self.cfg = port_config(self.model)
        params = make_params(self.model, ctx.seed, self.device)
        kw = {}
        if ctx.trace:
            os.makedirs(ctx.scratch, exist_ok=True)
            # step-phase spans on; the file is written only by close()
            kw["metrics_out"] = os.path.join(ctx.scratch, "metrics.json")
        self.eng = ServeEngine(
            self.cfg, sparsity=self.model["sparsity"],
            head_sparsity=self.model["head_sparsity"],
            seed=ctx.seed % 2**31, params=params, device=self.device,
            **engine_options(e), **kw)
        del params
        if ctx.trace:
            self.undo = profiling.instrument(self.log)
            profiling.warm(self.device)
        make = (manifest.generator(ctx.cell["traffic"], ctx.root)
                or traffic.serve_requests)
        self.specs = make(self.mix, self.model["token_ids"], ctx.seed,
                          ctx.seconds)
        self.eng.warmup()
        if self.mix["loop"] == "closed":
            self._build_sessions()
        else:
            self._warm_open()
        self._sync()

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def _submit(self, spec, t_sched) -> Track:
        h = self.eng.submit(spec["prompt"], spec["max_new_tokens"],
                            arrival=0.0, temperature=spec["temperature"],
                            seed=spec["seed"], top_k=spec["top_k"])
        return Track(spec, h, t_sched)

    def _build_sessions(self) -> None:
        """Submit the sessions and the backlog; step until every session
        has its first token (its cache built)."""
        if self.mix["sessions"] != self.mix["engine"]["num_slots"]:
            raise SystemExit("a closed loop's sessions fill its slots")
        self.tracks = [self._submit(s, 0.0) for s in self.specs]
        sessions = [t for t in self.tracks if t.spec["session"]]
        longest = max(sessions, key=lambda t: len(t.spec["prompt"]))
        rest = [t for t in sessions if t is not longest]
        pick = rng(self.ctx.seed, 4).permutation(len(rest))
        self.judged = [longest] + [rest[j] for j in
                                   pick[:self.mix["check_requests"] - 1]]
        self.rows = [[] for _ in self.judged]
        self._capture()
        while any(not t.h.tokens for t in sessions):
            self._advance()

    def _capture(self) -> None:
        """Keep the judged sessions' rows of every decode step's logits."""
        step_fn = self.eng._step_fn

        def capturing(*a, **kw):
            out = step_fn(*a, **kw)
            if self._slots is None:
                # every session is admitted before the first decode
                self._slots = torch.tensor([t.h.slot for t in self.judged],
                                           device=self.device)
            self._last = out[1].index_select(0, self._slots)
            return out
        self.eng._step_fn = capturing

    def _advance(self) -> None:
        """One engine step; each judged session served a token in it
        keeps that token's logit row."""
        before = [len(t.h.tokens) for t in self.judged]
        self._last = None
        self.eng.step()
        for j, t in enumerate(self.judged):
            if len(t.h.tokens) > before[j]:
                assert len(t.h.tokens) == before[j] + 1
                self.rows[j].append(self._last[j])

    def _warm_open(self) -> None:
        """Serve one greedy and one sampled request of two prefill chunks
        through every path the mix takes (prefill, paged decode, the
        sampler with per-slot top-k)."""
        e = self.mix["engine"]
        plen = 2 * e["prefill_chunk"] + 1
        for spec in self.specs:
            if not spec["greedy"]:
                break
        warm = [dict(spec, prompt=spec["prompt"][:1] * plen,
                     max_new_tokens=4),
                dict(spec, prompt=spec["prompt"][:1] * plen,
                     max_new_tokens=4, temperature=0.0, top_k=None)]
        tracks = [self._submit(w, 0.0) for w in warm]
        while self.eng.scheduler.has_work:
            self.eng.step()
        assert all(len(t.h.tokens) == 4 for t in tracks)

    # ------------------------------------------------------------ window --
    def _counters(self):
        eng = self.eng
        pre = eng.planner.tokens_prefilled if eng.planner else 0
        enq = 0.0
        if eng.spans is not None:
            # the prefill phase ends in a wait for the device, as
            # host_sync does: neither is host work
            enq = sum(h.sum for p, h in eng.spans.h_phase.items()
                      if p not in ("host_sync", "prefill"))
        return eng.metrics.get("steps.active_slots").value, pre, enq

    def _step(self, live: List[Track], profiled: bool) -> float:
        """One engine step, timed; each live request's new tokens and
        admission stamped.  Returns the step's end."""
        c0 = self._counters()
        self.log.step = len(self.steps)
        ts = time.perf_counter()
        with torch.profiler.record_function("portbench.step"):
            self._advance()
        te = time.perf_counter()
        c1 = self._counters()
        rec = {"t": ts, "dt": te - ts, "decode_rows": c1[0] - c0[0],
               "prefill_rows": c1[1] - c0[1], "enqueue_s": c1[2] - c0[2],
               "profiled": profiled}
        if self.ctx.trace and not profiled:
            rec["context"] = sum(len(t.spec["prompt"]) + len(t.h.tokens)
                                 for t in live if t.h.tokens
                                 and t.h.state.name == "ACTIVE")
        self.steps.append(rec)
        for t in live:
            if t.t_admit is None and t.h.t_admit is not None:
                t.t_admit = ts
            while len(t.times) < len(t.h.tokens):
                t.times.append(te)
        return te

    def window(self) -> Dict:
        if self.mix["loop"] == "closed":
            return self._closed()
        return self._open()

    def _maybe_profile(self, elapsed: float) -> bool:
        """Start the profiled span (traced runs: the window's last
        ``profile_s``); True from then on."""
        if (self.ctx.trace and self.profile is None
                and elapsed >= self.ctx.seconds - self.mix["profile_s"]):
            self.profile = profiling.Profiled(self.device).__enter__()
            self.log.active = True
        return self.profile is not None

    def _end_profile(self) -> None:
        if self.profile is not None:
            self.log.active = False
            self.profile.__exit__(None, None, None)

    def _closed(self) -> Dict:
        start = {id(t): len(t.h.tokens) for t in self.tracks}
        t0 = time.perf_counter()
        self.t0 = t0
        while True:
            prof = self._maybe_profile(time.perf_counter() - t0)
            te = self._step(self.tracks, prof)
            if te - t0 >= self.ctx.seconds:
                break
        self._end_profile()
        self.t_end = te
        generated = sum(len(t.h.tokens) - start[id(t)] for t in self.tracks)
        self.attempted = sum(1 for t in self.tracks if t.h.t_admit is not None)
        self.failed = sum(1 for t in self.tracks
                          if t.h.state.name in ("EXPIRED", "SHED",
                                                "CANCELLED"))
        return {"decode_tok_s": generated / (te - t0)}

    def _open(self) -> Dict:
        eng = self.eng
        self.tracks, live = [], []
        t0 = time.perf_counter()
        self.t0 = t0
        i, n = 0, len(self.specs)
        while True:
            now = time.perf_counter()
            while i < n and t0 + self.specs[i]["due_s"] <= now:
                tr = self._submit(self.specs[i], t0 + self.specs[i]["due_s"])
                self.tracks.append(tr)
                live.append(tr)
                i += 1
            if now - t0 >= self.ctx.seconds:
                break
            prof = self._maybe_profile(now - t0)
            if not eng.scheduler.has_work:
                nxt = t0 + (self.specs[i]["due_s"] if i < n
                            else self.ctx.seconds)
                time.sleep(max(0.0, min(nxt, t0 + self.ctx.seconds)
                               - time.perf_counter()))
                continue
            self._step(live, prof)
            live = [t for t in live if not _finished(t)]
        self._end_profile()
        self.t_end = time.perf_counter()
        # late answers are late, not wrong: wait for every first token
        while (any(not t.times for t in self.tracks)
               and time.perf_counter() - self.t_end < 60
               and eng.scheduler.has_work):
            self._step(live, True)
            live = [t for t in live if not _finished(t)]
        self.attempted = len(self.tracks)
        self.unanswered = sum(1 for t in self.tracks if not t.times)
        self.failed = self.unanswered
        ttft = [t.times[0] - t.t_sched for t in self.tracks if t.times]
        itl = [b - a for t in self.tracks
               for a, b in zip(t.times, t.times[1:]) if b <= self.t_end]
        if not ttft or not itl:
            raise RuntimeError(f"no time to first token or no gap between "
                               f"tokens in the window ({len(ttft)}, "
                               f"{len(itl)}): the window is too short")
        return {"ttft_p90_ms": 1e3 * percentile(ttft, 90),
                "itl_p95_ms": 1e3 * percentile(itl, 95)}

    # ----------------------------------------------------- check and free --
    def release(self) -> Dict:
        """The requests the check judges, and the program's state freed.
        A closed loop judges its judged sessions (every token served so
        far, with its logit row), an open loop greedy requests it
        finished (their tokens), the one with the most served tokens and
        the rest drawn from the seed."""
        if self.judged:
            self.samples = [(list(t.spec["prompt"]), list(t.h.tokens),
                             torch.stack(r)) for t, r in
                            zip(self.judged, self.rows)]
        else:
            pool = [t for t in self.tracks if t.spec["greedy"]
                    and t.h.state.name == "DONE" and t.h.tokens]
            want = self.mix["check_requests"]
            longest = (max(pool, key=lambda t: len(t.h.tokens))
                       if pool else None)
            rest = [t for t in pool if t is not longest]
            pick = rng(self.ctx.seed, 4).permutation(len(rest))[:want - 1]
            chosen = ([longest] if longest else []) + [rest[j] for j in pick]
            self.samples = [(list(t.spec["prompt"]), list(t.h.tokens), None)
                            for t in chosen]
        self.rows = self._last = None
        if self.ctx.trace:
            self.undo()
        self.eng = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return {"samples": self.samples}


def _finished(t: Track) -> bool:
    return t.h.state.name in ("DONE", "CANCELLED", "EXPIRED", "SHED")

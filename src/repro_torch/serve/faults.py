"""Deterministic fault injection + step-level invariant auditing for the
serving engine.

Port of ``repro/serve/faults.py`` over torch tensors: the same plans,
the same seeded draws in the same order over the same ``leaves()``, so
one plan hits the same tensor, field and bit as in the reference, and
the same CRC32 checksums (taken over the host bytes of the packed
arrays, which equal the reference's for the same weights).

SparTen-style sparse datapaths fail *subtly*: a corrupted index or value
tile doesn't crash, it silently serves garbage, and an allocator whose
refcounts drift leaks pages long before anything visibly breaks.  This
module is the software analogue of a hardware fault campaign — every
recovery path in ``serve/`` gets exercised on demand, deterministically:

* ``FaultPlan`` — a seeded schedule of injected faults, fired by the
  engine at the top of each step.  Five fault kinds cover the engine's
  failure surface:

  - ``page_squeeze``: confiscate free pages (restored after
    ``duration`` steps) — drives out-of-pages admission queueing
    (strict mode) or preemption storms (``preempt=True``);
  - ``force_preempt``: preempt the youngest non-pinned slot(s) —
    drives requeue/replay regardless of pool pressure;
  - ``evict_storm``: flush the entire shared-prefix cache — drives
    cold re-registration and COW bookkeeping after mass eviction;
  - ``nan_logits``: poison the packed LM head's value payload (and its
    ``dense_cache`` — the plain version on the CPU reads it) with NaN —
    drives the sampler-corruption detection path;
  - ``bitflip``: flip one bit in a seeded packed tensor's value or
    bitmap array (mirrored into ``dense_cache``) — drives per-tensor
    integrity detection and dense quarantine.

  Faults mutate *weights and allocator state only* — never the request
  queue — so with ``audit=True`` every fault is recoverable and the
  served tokens stay bit-identical to a fault-free run (packing is
  lossless, replay is deterministic, quarantine falls back to the same
  numerics).  That equivalence is the chaos suite's core assertion.

* ``InvariantAuditor`` — the ``audit=True`` knob's engine-side checker.
  Once per step it audits the scheduler's slot bookkeeping, the page
  allocator (refcount conservation, free xor referenced, table
  aliasing), the prefill planner, request-state legality, and logits
  finiteness; and it keeps pack-time CRC32 checksums of every packed
  tensor so ``integrity_scan()`` can attribute corruption to a specific
  tensor for quarantine.  Violations raise ``AuditViolation`` — an
  audit failure is a bug, never control flow.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.serve.errors import AuditViolation
from repro_torch.serve.request import TERMINAL_STATES, RequestState

if TYPE_CHECKING:                     # pragma: no cover - typing only
    from repro_torch.serve.engine import ServeEngine

FAULT_KINDS = ("page_squeeze", "force_preempt", "evict_storm",
               "nan_logits", "bitflip")


@dataclasses.dataclass
class Fault:
    """One scheduled fault.  ``step`` is the engine step at whose start
    it fires; the remaining fields are kind-specific knobs."""

    step: int
    kind: str
    pages: int = 4        # page_squeeze: pages confiscated per pool
    duration: int = 4     # page_squeeze: steps until pages are restored
    count: int = 1        # force_preempt: victims this firing
    tensor: Optional[str] = None  # bitflip: target path (None = seeded)
    field: str = "values"         # bitflip: "values" or "bitmap"

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    Build one with the per-kind helpers (``page_squeeze(step=...)`` …)
    or ``FaultPlan.chaos(seed, horizon)`` for one of each kind at seeded
    steps; pass it to ``ServeEngine(..., faults=plan)``.  The engine
    calls ``fire`` at the top of every step; everything the plan did (or
    skipped, with a reason) lands in ``plan.log``.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.faults: List[Fault] = []
        self.log: List[Dict] = []
        self._rng = np.random.default_rng(seed)
        self._restores: List[int] = []   # steps at which to restore pages

    # ------------------------------------------------------- schedule ----

    def add(self, fault: Fault) -> "FaultPlan":
        self.faults.append(fault)
        return self

    def page_squeeze(self, step: int, pages: int = 4,
                     duration: int = 4) -> "FaultPlan":
        return self.add(Fault(step, "page_squeeze", pages=pages,
                              duration=duration))

    def force_preempt(self, step: int, count: int = 1) -> "FaultPlan":
        return self.add(Fault(step, "force_preempt", count=count))

    def evict_storm(self, step: int) -> "FaultPlan":
        return self.add(Fault(step, "evict_storm"))

    def nan_logits(self, step: int) -> "FaultPlan":
        return self.add(Fault(step, "nan_logits"))

    def bitflip(self, step: int, tensor: Optional[str] = None,
                field: str = "values") -> "FaultPlan":
        assert field in ("values", "bitmap")
        return self.add(Fault(step, "bitflip", tensor=tensor, field=field))

    @classmethod
    def chaos(cls, seed: int = 0, horizon: int = 48) -> "FaultPlan":
        """One of every fault kind at seeded steps inside ``horizon``."""
        plan = cls(seed)
        rng = np.random.default_rng(seed)
        lo, hi = max(2, horizon // 8), max(3, horizon - 4)
        steps = sorted(int(s) for s in rng.integers(lo, hi,
                                                    len(FAULT_KINDS)))
        plan.page_squeeze(steps[0], pages=int(rng.integers(2, 6)),
                          duration=int(rng.integers(2, 8)))
        plan.force_preempt(steps[1], count=int(rng.integers(1, 3)))
        plan.evict_storm(steps[2])
        plan.nan_logits(steps[3])
        plan.bitflip(steps[4],
                     field="values" if rng.integers(2) else "bitmap")
        return plan

    # ----------------------------------------------------------- fire ----

    def fire(self, engine: "ServeEngine", step: int) -> None:
        """Inject every fault scheduled for ``step`` (and restore any
        page squeeze whose duration elapsed).  Called by the engine at
        the top of the step, before admission."""
        due_restores = [s for s in self._restores if s <= step]
        if due_restores:
            self._restores = [s for s in self._restores if s > step]
            n = engine.kv.restore_held() if engine.page_len else 0
            self.log.append({"step": step, "kind": "page_restore",
                             "pages": n})
        for f in self.faults:
            if f.step == step:
                getattr(self, f"_fire_{f.kind}")(engine, f, step)

    def _skip(self, step: int, kind: str, reason: str) -> None:
        self.log.append({"step": step, "kind": kind, "fired": False,
                         "reason": reason})

    def _fire_page_squeeze(self, engine, f: Fault, step: int) -> None:
        if not engine.page_len:
            return self._skip(step, f.kind, "engine is not paged")
        taken = engine.kv.confiscate(f.pages)
        self._restores.append(step + max(1, f.duration))
        self.log.append({"step": step, "kind": f.kind, "fired": True,
                         "pages": taken, "until": step + f.duration})

    def _fire_force_preempt(self, engine, f: Fault, step: int) -> None:
        fired = 0
        for _ in range(f.count):
            victims = [s for s in engine.scheduler.active
                       if not engine._pinned(s)]
            if not victims:
                break
            victim = max(victims, key=lambda s: engine._admit_seq[s])
            engine._preempt_slot(victim)
            engine._c_forced_preempts.inc()
            fired += 1
        if fired:
            self.log.append({"step": step, "kind": f.kind, "fired": True,
                             "count": fired})
        else:
            self._skip(step, f.kind, "no preemptable active slot")

    def _fire_evict_storm(self, engine, f: Fault, step: int) -> None:
        if not engine.page_len or not engine.prefix_reuse:
            return self._skip(step, f.kind, "prefix reuse not enabled")
        n = engine.kv.flush_prefix()
        self.log.append({"step": step, "kind": f.kind, "fired": True,
                         "evicted_blocks": n})

    def _fire_nan_logits(self, engine, f: Fault, step: int) -> None:
        bw = engine.lm_weight
        if bw is None:
            return self._skip(step, f.kind,
                              "no packed LM head to poison")
        engine.lm_weight = dataclasses.replace(
            bw,
            values=torch.full_like(bw.values, math.nan),
            dense_cache=(torch.full_like(bw.dense_cache, math.nan)
                         if bw.dense_cache is not None else None))
        self.log.append({"step": step, "kind": f.kind, "fired": True,
                         "tensor": "lm_head"})

    def _fire_bitflip(self, engine, f: Fault, step: int) -> None:
        if engine.packed is None:
            return self._skip(step, f.kind, "no packed stack")
        leaves = engine.packed.leaves()
        if not leaves:
            return self._skip(step, f.kind, "every tensor already dense")
        if f.tensor is not None:
            hit = [(p, bw) for p, bw in leaves if p == f.tensor]
            if not hit:
                return self._skip(step, f.kind,
                                  f"{f.tensor} not packed")
            path, bw = hit[0]
        else:
            path, bw = leaves[int(self._rng.integers(len(leaves)))]
        arr = bw.values if f.field == "values" else bw.packed_bits
        # flip the bit in a host copy, then move it back to the device
        host = arr.cpu().numpy().copy()
        flat = host.view(np.uint8).reshape(-1)
        bit = int(self._rng.integers(flat.size * 8))
        flat[bit // 8] ^= np.uint8(1 << (bit % 8))
        fields = {f.field if f.field == "values" else "packed_bits":
                  torch.from_numpy(host).to(arr.device)}
        if bw.dense_cache is not None:
            # the plain version on the CPU multiplies by dense_cache, so
            # mirror some corruption there too — which tensor is corrupt
            # is what matters (detection is via the canonical packed
            # arrays)
            dc = bw.dense_cache.cpu().numpy().copy()
            dcf = dc.view(np.uint8).reshape(-1)
            dcf[bit // 8 % dcf.size] ^= np.uint8(1 << (bit % 8))
            fields["dense_cache"] = torch.from_numpy(dc).to(
                bw.dense_cache.device)
        engine.packed.replace_leaf(path,
                                   dataclasses.replace(bw, **fields))
        self.log.append({"step": step, "kind": f.kind, "fired": True,
                         "tensor": path, "field": f.field, "bit": bit})

    # --------------------------------------------------------- report ----

    def register_metrics(self, reg) -> None:
        """Expose the plan's firing counts as registry gauges."""
        reg.gauge("faults.planned", lambda: len(self.faults))
        reg.gauge("faults.fired",
                  lambda: sum(1 for e in self.log if e.get("fired")))
        reg.gauge("faults.skipped",
                  lambda: sum(1 for e in self.log if not e.get("fired")))

    def summary(self) -> Dict:
        fired = [e for e in self.log if e.get("fired")]
        by_kind: Dict[str, int] = {}
        for e in fired:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        return {"seed": self.seed, "planned": len(self.faults),
                "fired": len(fired),
                "skipped": len(self.log) - len(fired), "by_kind": by_kind,
                "log": list(self.log)}


def _checksum(bw) -> int:
    """CRC32 over a BitmapWeight's canonical arrays (bits + values +
    row starts), each copied to the host; ``dense_cache`` is a derived
    rendering and excluded."""
    crc = 0
    for t in (bw.packed_bits, bw.values, bw.row_start):
        crc = zlib.crc32(t.contiguous().cpu().numpy(), crc)
    return crc


class InvariantAuditor:
    """The engine's ``audit=True`` checker: per-step structural
    invariants plus packed-tensor integrity attribution."""

    def __init__(self, engine: "ServeEngine"):
        self.engine = engine
        self.steps_checked = 0
        self.integrity_scans = 0
        self._sums: Dict[str, int] = {}
        if engine.packed is not None:
            for path, bw in engine.packed.leaves():
                self._sums[path] = _checksum(bw)
        if engine.lm_weight is not None:
            self._sums["lm_head"] = _checksum(engine.lm_weight)

    def drop(self, path: str) -> None:
        """Forget a quarantined tensor's checksum (it no longer has a
        packed representation to verify)."""
        self._sums.pop(path, None)

    # ------------------------------------------------------ integrity ----

    def integrity_scan(self) -> List[str]:
        """Paths whose packed arrays no longer match their pack-time
        checksum, or carry non-finite values — the quarantine list.
        The checksum copies every packed tensor to the host; the finite
        check runs where the values lie."""
        self.integrity_scans += 1
        eng = self.engine
        live = dict(eng.packed.leaves()) if eng.packed is not None else {}
        if eng.lm_weight is not None:
            live["lm_head"] = eng.lm_weight
        bad = []
        for path, bw in live.items():
            want = self._sums.get(path)
            if want is None:
                continue
            if (_checksum(bw) != want
                    or not bool(torch.isfinite(bw.values).all())):
                bad.append(path)
        return bad

    # ----------------------------------------------------- invariants ----

    def check_step(self) -> None:
        """Audit every structural invariant after an engine step."""
        eng = self.engine
        eng.scheduler.audit()
        if eng.page_len:
            eng.kv.audit()
        if eng.planner is not None:
            eng.planner.audit(set(eng.scheduler.active))
        ingest = set(eng._ingest)
        active = set(eng.scheduler.active)
        if ingest != active:
            raise AuditViolation(
                f"ingest bookkeeping drift: ingest slots "
                f"{sorted(ingest)} != active {sorted(active)}")
        for slot, req in eng.scheduler.active.items():
            if len(req.tokens) > req.max_new_tokens:
                raise AuditViolation(
                    f"rid {req.rid} over-generated: {len(req.tokens)} > "
                    f"{req.max_new_tokens}")
        for req in eng.requests:
            if req.state not in TERMINAL_STATES:
                raise AuditViolation(
                    f"retired rid {req.rid} in non-terminal state "
                    f"{req.state.value}")
            if req.state is RequestState.DONE and req.error is not None:
                raise AuditViolation(
                    f"DONE rid {req.rid} carries error {req.error!r}")
        self.steps_checked += 1

    def check_logits(self, logits: np.ndarray, rows: List[int]) -> None:
        """Finite-logits invariant for the step's decoding rows.  Runs
        only after the integrity scan came back clean, so a violation
        here means corruption with no attributable tensor."""
        if not rows:
            return
        if not np.isfinite(logits[rows]).all():
            raise AuditViolation(
                "non-finite logits with no corrupted packed tensor to "
                "quarantine (rows %s)" % rows)

    def register_metrics(self, reg) -> None:
        reg.gauge("audit.steps_checked", lambda: self.steps_checked)
        reg.gauge("audit.integrity_scans", lambda: self.integrity_scans)
        reg.gauge("audit.checksummed_tensors", lambda: len(self._sums))

    def report(self) -> Dict:
        return {"enabled": True, "steps_checked": self.steps_checked,
                "integrity_scans": self.integrity_scans,
                "checksummed_tensors": len(self._sums)}

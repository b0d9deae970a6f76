"""Slot-based continuous-batching scheduler.

The decode batch has a fixed width (``num_slots``); requests are admitted
into freed slots *mid-flight* — there is no drain barrier, so the array
stays fed at full batch width under a stream of arrivals (the EIE
observation: compressed-weight inference pays off when the engine keeps
many concurrent requests in the array).

Admission is FIFO by (arrival, rid), which gives the no-starvation
property tested in tests/test_serve_engine.py: a request can only be
passed over by requests that arrived strictly earlier.  A *preempted*
request (``requeue``) keeps its original arrival, so it goes back to the
head of the line — the engine preempts youngest-first and re-admits
oldest-first, which is what makes recompute-on-preempt starvation-free.

Bookkeeping is bounded: the admission-order trace keeps only the last
``history`` rids (a deque), with a monotonic ``admitted_total`` counter —
a long-lived engine's memory does not grow with total traffic.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

from repro_torch.serve.errors import AuditViolation
from repro_torch.serve.request import Request, RequestState


class SlotScheduler:
    def __init__(self, num_slots: int, history: int = 4096):
        assert num_slots >= 1
        self.num_slots = num_slots
        self.free: deque = deque(range(num_slots))
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}
        self._admitted_rids: deque = deque(maxlen=max(1, history))
        self.admitted_total = 0
        self.preemptions = 0

    # ------------------------------------------------------------ queue ----

    def submit(self, req: Request) -> None:
        req.transition(RequestState.WAITING)
        self.waiting.append(req)

    def admit(self, now: float, fits=None) -> List[Tuple[int, Request]]:
        """Move due requests into free slots, FIFO by (arrival, rid).

        ``fits(req) -> bool`` is an optional capacity gate (the paged
        engine's out-of-pages check).  Admission stays strictly FIFO: a
        head-of-line request that doesn't fit *blocks* later requests
        rather than being skipped, preserving the no-starvation property
        — it waits in the queue until retirements free capacity.
        """
        admitted = []
        while self.free:
            due = [r for r in self.waiting if r.arrival <= now]
            if not due:
                break
            req = min(due, key=lambda r: (r.arrival, r.rid))
            if fits is not None and not fits(req):
                break
            self.waiting.remove(req)
            slot = self.free.popleft()
            self.active[slot] = req
            req.slot = slot
            req.transition(RequestState.ACTIVE)
            self._admitted_rids.append(req.rid)
            self.admitted_total += 1
            admitted.append((slot, req))
        return admitted

    def release(self, slot: int,
                state: RequestState = RequestState.DONE) -> Request:
        """Free a slot into any terminal state (DONE by default; the
        engine passes CANCELLED / EXPIRED for aborted requests)."""
        req = self.active.pop(slot)
        req.transition(state)
        self.free.append(slot)
        return req

    def requeue(self, slot: int) -> Request:
        """Preempt: push the slot's request back onto the waiting queue
        (state WAITING, original arrival kept — it re-sorts to the head
        of the FIFO) and free the slot.  The engine re-ingests the
        request's generated prefix on re-admission."""
        req = self.active.pop(slot)
        req.transition(RequestState.WAITING)
        req.slot = None
        self.waiting.append(req)
        self.free.append(slot)
        self.preemptions += 1
        return req

    def cancel_waiting(self, req: Request) -> None:
        """Drop a queued request (client cancel / deadline expiry /
        shedding).  The caller applies the terminal transition."""
        self.waiting.remove(req)

    # ------------------------------------------------------------ views ----

    def register_metrics(self, reg) -> None:
        """Expose slot occupancy and admission counters as gauges."""
        reg.gauge("scheduler.waiting", lambda: len(self.waiting))
        reg.gauge("scheduler.active", lambda: len(self.active))
        reg.gauge("scheduler.free_slots", lambda: len(self.free))
        reg.gauge("scheduler.admitted_total",
                  lambda: self.admitted_total)
        reg.gauge("scheduler.preemptions", lambda: self.preemptions)

    @property
    def admitted_rids(self) -> List[int]:
        """Admission order, most recent ``history`` entries (for tests)."""
        return list(self._admitted_rids)

    @property
    def has_work(self) -> bool:
        return bool(self.active) or bool(self.waiting)

    @property
    def num_active(self) -> int:
        return len(self.active)

    def next_arrival(self) -> float:
        assert self.waiting
        return min(r.arrival for r in self.waiting)

    # ------------------------------------------------------------ audit ----

    def audit(self) -> None:
        """Slot-bookkeeping invariants (raises ``AuditViolation``):
        free and active slots partition [0, num_slots); no slot is freed
        twice; every active request agrees it owns its slot; every
        queued request is WAITING."""
        free = list(self.free)
        free_set, active_set = set(free), set(self.active)
        if len(free) != len(free_set):
            raise AuditViolation(f"duplicate free slot: {sorted(free)}")
        if free_set & active_set:
            raise AuditViolation(
                f"slot both free and active: {sorted(free_set & active_set)}")
        if free_set | active_set != set(range(self.num_slots)):
            raise AuditViolation(
                f"slots lost: free={sorted(free_set)} "
                f"active={sorted(active_set)} of {self.num_slots}")
        for slot, req in self.active.items():
            if req.state is not RequestState.ACTIVE or req.slot != slot:
                raise AuditViolation(
                    f"slot {slot}: rid {req.rid} state={req.state.value} "
                    f"claims slot {req.slot}")
        for req in self.waiting:
            if req.state is not RequestState.WAITING:
                raise AuditViolation(
                    f"queued rid {req.rid} in state {req.state.value}")

"""Chunked batched prefill planner for the serving engine.

A copy of ``repro/serve/prefill.py`` (host-side numpy bookkeeping; the
device work is ``models.model.prefill_hidden`` through
``launch.steps.build_prefill_step``).  Each admitted request's prompt
positions ``0 .. len(prompt) - 2`` are cut into ``chunk``-token pieces;
every engine step the chunks of all mid-prefill slots ride one padded
``(num_slots, chunk)`` call, with a per-slot length mask for the padding
lanes.  The last prompt token is never prefilled: it feeds the first
decode step, which samples the first generated token as the prompt walk
does.  At most one prefill call runs per engine step, so decode never
starves.  A prefix hit starts the plan past its adopted positions
(``start=``), a preemption drops it (``cancel``).  Metrics registration
comes with telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from repro_torch.serve.errors import AuditViolation


@dataclasses.dataclass
class PrefillJob:
    """One slot's remaining prompt ingestion."""

    prompt: List[int]
    next: int            # next prompt position to prefill
    end: int             # stop (exclusive): len(prompt) - 1


class PrefillPlanner:
    """Splits admitted prompts into chunks and batches them into calls.

    ``start(slot, prompt)`` registers a slot whose prompt needs
    prefilling (returns False for single-token prompts, which go
    straight to decode); ``next_call()`` assembles one padded
    ``(num_slots, chunk)`` batch covering every registered slot's next
    chunk and advances the plan.  The engine calls ``next_call`` at most
    once per step while ``has_work``.
    """

    def __init__(self, num_slots: int, chunk: int):
        assert chunk > 0
        self.num_slots = num_slots
        self.chunk = chunk
        self._jobs: Dict[int, PrefillJob] = {}
        self.calls = 0
        self.tokens_prefilled = 0

    # ------------------------------------------------------------ plan ----

    def start(self, slot: int, prompt: Sequence[int],
              start: int = 0) -> bool:
        """Register a freshly admitted slot; False = nothing to prefill
        (the prompt is a single token — decode consumes it directly).
        ``start`` skips positions already resident in the slot's cache
        (a shared-prefix hit: adopted pages cover ``0 .. start-1``; a
        full hit skips prefill entirely)."""
        assert slot not in self._jobs, f"slot {slot} already prefilling"
        end = len(prompt) - 1
        if end - start <= 0:
            return False
        self._jobs[slot] = PrefillJob(list(prompt), start, end)
        return True

    def cancel(self, slot: int) -> None:
        """Drop a slot's remaining plan (preemption or release): the
        engine re-ingests the whole prefix on re-admission."""
        self._jobs.pop(slot, None)

    @property
    def has_work(self) -> bool:
        return bool(self._jobs)

    def in_prefill(self, slot: int) -> bool:
        return slot in self._jobs

    def next_pos(self, slot: int) -> int:
        """The slot's next unwritten prompt position — the engine parks
        the slot's decode-passenger write there (the next chunk rewrites
        it, so the junk line is never read)."""
        return self._jobs[slot].next

    # ------------------------------------------------------------ call ----

    def next_call(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 List[int]]:
        """Assemble one batched prefill call and advance the plan.

        Returns ``(tokens (num_slots, chunk) int32, pos (num_slots,)
        int32, lens (num_slots,) int32, finished slots)`` — every
        registered slot contributes its next ``<= chunk`` prompt tokens;
        rows with ``lens == 0`` are padding lanes the device masks off.
        Slots whose last chunk this is are returned in ``finished`` and
        leave the plan (the engine flips them to decode phase).
        """
        assert self._jobs, "next_call with no prefill work"
        tokens = np.zeros((self.num_slots, self.chunk), np.int32)
        pos = np.zeros(self.num_slots, np.int32)
        lens = np.zeros(self.num_slots, np.int32)
        finished: List[int] = []
        for slot in sorted(self._jobs):
            job = self._jobs[slot]
            n = min(self.chunk, job.end - job.next)
            tokens[slot, :n] = job.prompt[job.next:job.next + n]
            pos[slot] = job.next
            lens[slot] = n
            job.next += n
            if job.next >= job.end:
                finished.append(slot)
        for slot in finished:
            del self._jobs[slot]
        self.calls += 1
        self.tokens_prefilled += int(lens.sum())
        return tokens, pos, lens, finished

    # ------------------------------------------------------------ audit ----

    def audit(self, active_slots: Set[int]) -> None:
        """Planner invariants (raises ``AuditViolation``): every job
        belongs to an active slot, and its cursor stays inside the
        prompt."""
        for slot, job in self._jobs.items():
            if slot not in active_slots:
                raise AuditViolation(
                    f"prefill job for slot {slot} which is not active")
            if not (0 <= job.next <= job.end <= len(job.prompt)):
                raise AuditViolation(
                    f"prefill cursor out of range for slot {slot}: "
                    f"next={job.next} end={job.end} "
                    f"prompt={len(job.prompt)}")

    # --------------------------------------------------------- reports ----

    def register_metrics(self, reg) -> None:
        reg.gauge("prefill.calls", lambda: self.calls)
        reg.gauge("prefill.tokens", lambda: self.tokens_prefilled)
        reg.gauge("prefill.in_flight", lambda: len(self._jobs))

    def report(self) -> Dict:
        lanes = self.calls * self.num_slots * self.chunk
        return {
            "chunk": self.chunk,
            "calls": self.calls,
            "tokens_prefilled": self.tokens_prefilled,
            "in_flight": len(self._jobs),
            "lane_utilization": (self.tokens_prefilled / lanes
                                 if lanes else None),
        }

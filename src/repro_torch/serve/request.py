"""Serving request state.

A ``Request`` carries everything the engine needs across its lifetime:
the prompt, the generation budget, the arrival offset (measured in decode
steps so traces are deterministic regardless of host speed), and the
timing marks the benchmark turns into latency percentiles.

Lifecycle: every request ends in exactly one terminal state —

  DONE        generation budget exhausted, all tokens delivered
  CANCELLED   client called ``engine.cancel(rid)``; partial tokens kept
  EXPIRED     ``deadline_ms`` elapsed (measured from arrival-due);
              ``DeadlineExceeded`` recorded, partial tokens kept
  SHED        admission control refused it under overload;
              ``ServeOverloaded`` recorded, no tokens

``transition()`` enforces the legal state machine (audited per step when
the engine runs with ``audit=True``), and ``result()`` gives callers the
tokens-or-typed-error view of the outcome.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.serve.errors import (AuditViolation, RequestRejected,
                                      ServeError)

__all__ = ["Request", "RequestRejected", "RequestState"]


class RequestState(enum.Enum):
    WAITING = "waiting"     # submitted, not yet admitted to a slot
    ACTIVE = "active"       # owns a batch slot, decoding
    DONE = "done"           # generation budget exhausted, slot released
    CANCELLED = "cancelled"  # client-cancelled (queued or mid-flight)
    EXPIRED = "expired"     # deadline_ms elapsed before completion
    SHED = "shed"           # refused by admission control under overload


#: Terminal states — once entered, no further transition is legal.
TERMINAL_STATES: Set[RequestState] = {
    RequestState.DONE, RequestState.CANCELLED, RequestState.EXPIRED,
    RequestState.SHED,
}

#: The legal request-state machine.  WAITING -> WAITING is allowed so
#: (re)enqueueing an already-waiting request stays idempotent;
#: ACTIVE -> WAITING is the preemption requeue edge.
_TRANSITIONS: Dict[RequestState, Set[RequestState]] = {
    RequestState.WAITING: {RequestState.WAITING, RequestState.ACTIVE,
                           RequestState.CANCELLED, RequestState.EXPIRED,
                           RequestState.SHED},
    RequestState.ACTIVE: {RequestState.DONE, RequestState.WAITING,
                          RequestState.CANCELLED, RequestState.EXPIRED},
    RequestState.DONE: set(),
    RequestState.CANCELLED: set(),
    RequestState.EXPIRED: set(),
    RequestState.SHED: set(),
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival: float = 0.0            # decode-step offset at which it arrives
    temperature: float = 0.0        # 0 = greedy; > 0 samples logits / T
    seed: Optional[int] = None      # per-request sampling stream (None:
    #                                 engine derives one from the rid)
    top_k: Optional[int] = None     # per-request top-k truncation (None:
    #                                 engine default; 0 = no truncation)
    deadline_ms: Optional[float] = None  # latency budget measured from the
    #                                 moment the arrival offset comes due
    #                                 (None: engine default / no deadline)

    # -- filled in by the engine --
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None      # last slot owned (kept after release)
    state: RequestState = RequestState.WAITING
    error: Optional[ServeError] = None  # typed terminal error (EXPIRED /
    #                                 SHED); None for DONE and CANCELLED
    admit_step: Optional[int] = None
    done_step: Optional[int] = None
    t_due: Optional[float] = None   # wall time the arrival offset was reached
    t_admit: Optional[float] = None  # wall time a slot was granted
    t_prefill_done: Optional[float] = None  # wall time the prompt cache was
    #                                 resident (last prefill chunk, or the
    #                                 last teacher-forced prompt step)
    t_first: Optional[float] = None  # wall time of the first generated token
    t_done: Optional[float] = None   # wall time generation finished
    t_preempt: List[float] = dataclasses.field(default_factory=list)
    #                                 wall times this request was preempted
    #                                 (pages reclaimed, re-queued, its
    #                                 prefix later recomputed)
    prefix_hit_tokens: int = 0       # prompt tokens adopted from the
    #                                 shared-prefix cache (prefill skipped)
    recomputed_tokens: int = 0       # positions re-ingested after
    #                                 preemption (recompute cost)

    def transition(self, new: RequestState) -> None:
        """Move to ``new``, enforcing the legal state machine."""
        if new not in _TRANSITIONS[self.state]:
            raise AuditViolation(
                f"illegal request-state transition {self.state.value} -> "
                f"{new.value} (rid {self.rid})")
        self.state = new

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def result(self) -> List[int]:
        """Generated tokens, or raise this request's typed terminal
        error (``DeadlineExceeded`` / ``ServeOverloaded``).  Cancelled
        requests return their partial tokens — the client asked."""
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    @property
    def latency_s(self) -> Optional[float]:
        """Queue + decode wall latency (arrival -> last token)."""
        if self.t_due is None or self.t_done is None:
            return None
        return self.t_done - self.t_due

    @property
    def first_token_s(self) -> Optional[float]:
        """Total TTFT (arrival -> first generated token) — the sum of the
        queue / prefill / first-decode components below."""
        if self.t_due is None or self.t_first is None:
            return None
        return self.t_first - self.t_due

    @property
    def queue_s(self) -> Optional[float]:
        """Arrival -> slot granted: pure queueing, no compute."""
        if self.t_due is None or self.t_admit is None:
            return None
        return self.t_admit - self.t_due

    @property
    def prefill_s(self) -> Optional[float]:
        """Slot granted -> prompt cache resident (chunked prefill calls,
        or the one-token-per-step teacher-forced walk in legacy mode)."""
        if self.t_admit is None or self.t_prefill_done is None:
            return None
        return self.t_prefill_done - self.t_admit

    @property
    def first_decode_s(self) -> Optional[float]:
        """Prompt resident -> first generated token (the first real
        decode step, including any wait for its turn in the batch)."""
        if self.t_prefill_done is None or self.t_first is None:
            return None
        return self.t_first - self.t_prefill_done

    def timeline(self):
        """Lifecycle as trace rows: ``(spans, instants)`` where spans is
        ``[(name, t_begin, t_end), ...]`` over QUEUED / PREFILL / DECODE
        and instants marks each preemption.  Tolerant of partial marks —
        an aborted request emits only the phases it reached, each closed
        at the latest timestamp it recorded."""
        marks = [t for t in (self.t_due, self.t_admit,
                             self.t_prefill_done, self.t_done)
                 if t is not None]
        if not marks:
            return [], []
        end = max(marks)
        spans = []
        if self.t_due is not None:
            spans.append(("QUEUED", self.t_due,
                          self.t_admit if self.t_admit is not None
                          else end))
        if self.t_admit is not None:
            spans.append(("PREFILL", self.t_admit,
                          self.t_prefill_done
                          if self.t_prefill_done is not None else end))
        if self.t_prefill_done is not None:
            spans.append(("DECODE", self.t_prefill_done,
                          self.t_done if self.t_done is not None
                          else end))
        instants = [("preempt", t) for t in self.t_preempt]
        return spans, instants

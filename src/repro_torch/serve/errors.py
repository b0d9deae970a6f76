"""Typed error hierarchy for the serving engine.

Every failure the engine can hand a caller derives from ``ServeError``,
so clients catch one base instead of memorising per-module exception
types.  The concrete classes keep their historical stdlib bases
(``ValueError`` for submit-time rejection, ``RuntimeError`` for
allocator exhaustion) so pre-hierarchy callers keep working.

Terminal request outcomes map onto this hierarchy: an EXPIRED request
records a ``DeadlineExceeded``, a SHED request a ``ServeOverloaded``,
and ``Request.result()`` re-raises whichever was recorded.
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "AuditViolation",
    "DeadlineExceeded",
    "OutOfPages",
    "RequestRejected",
    "ServeError",
    "ServeOverloaded",
]


class ServeError(Exception):
    """Base of every typed serving-engine error."""


class RequestRejected(ServeError, ValueError):
    """A submitted request can never be served under the engine's
    configuration (prompt too long for ``max_len``, need exceeds the
    page pool, empty prompt, non-positive token budget).  Raised at
    ``submit()`` time — rejection is immediate, never queued."""


class OutOfPages(ServeError, RuntimeError):
    """A page pool ran out of free pages mid-flight.

    Under the strict (worst-case) commitment policy this is converted
    to an AssertionError — admission guarantees it cannot happen — and
    under ``preempt=True`` it is caught internally and answered by
    preempting a slot.  It escapes to callers only via direct
    ``PagedKVCache`` use."""

    def __init__(self, bname: str):
        super().__init__(f"page pool exhausted for block {bname!r}")
        self.bname = bname


class ServeOverloaded(ServeError):
    """Admission-control backpressure: the engine is shedding load
    because queue depth or estimated TTFT exceeds its budget.  Raised
    by ``submit()`` for requests due immediately; queued requests that
    become due while the engine is overloaded are shed silently with
    this error recorded on the request."""

    def __init__(self, reason: str, queue_depth: Optional[int] = None,
                 est_ttft_s: Optional[float] = None):
        super().__init__(reason)
        self.reason = reason
        self.queue_depth = queue_depth
        self.est_ttft_s = est_ttft_s


class DeadlineExceeded(ServeError):
    """A request missed its ``deadline_ms`` budget (measured from the
    moment its arrival came due) and was expired — queued, mid-prefill,
    or mid-decode.  Recorded on the request; partial tokens are kept."""


class AuditViolation(ServeError, AssertionError):
    """A step-level invariant audit failed: refcount drift, free-list /
    referenced overlap, page-table aliasing, an illegal request-state
    transition, or non-finite logits with no corrupted tensor to
    quarantine.  Always a bug (or an unrecoverable injected fault) —
    never part of normal control flow."""

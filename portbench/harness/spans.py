"""The program's own ranges in a traced span's profiler events.

The program makes a profiler record at each of its layer boundaries
while a profiler runs (``repro_torch.counting.SPANS``: ``serve.step``
and ``serve.<phase>``, ``attn.decode``, ``moe``, ``kernel.<entry
point>``, ``train.grads``, ``train.update``).
``Spans`` reduces the events of a ``harness.profiling.Profiled`` span to
what the per-layer readers need:

- the device milliseconds under a range: the durations of the device
  operations (kernels, copies, sets) whose launch (the CUDA runtime or
  driver call with the same correlation id) the host made while the
  range was open, whatever op the profiler linked it to (it links an
  operation only to the innermost op around its launch).  A device-side
  annotation (a user range's extent from its first kernel's start to
  its last one's end, idle time included) is no operation;
- the idle gaps between device operations (the union of their
  intervals, as ``profiling.summarise`` takes it, and from the span's
  first event to the first operation and from the last operation to the
  span's last event), each put down to the ``serve.<phase>`` range the
  host was in at the gap's middle, to ``serve.step`` where it was
  between two phases of a step, or to ``OUTSIDE`` where it was outside
  every step;
- how many ranges of a name the span holds (``serve.step``: the steps).

A program without these ranges, or a span with no device time recorded
(the CPU), reads None everywhere.
"""
from __future__ import annotations

import bisect
import itertools
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

try:
    from repro_torch.counting import SPANS
except ImportError:          # a program that opens no ranges
    SPANS = frozenset()

OUTSIDE = "outside a step"
STEP = "serve.step"
# CUDA runtime (cudaLaunchKernel, cudaMemcpyAsync, ...) and driver
# (cuLaunchKernel, ...) calls: the host side of each device operation
LAUNCH = "cu"

_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _is_device(e) -> bool:
    return e.device_type.name != "CPU"


def _bounds(events) -> List:
    return sorted((e.time_range.start, e.time_range.end) for e in events)


class Spans:
    """The program's ranges in ``events`` (``FunctionEvent``s: ``id``
    (the correlation id of a launch and of its device operation),
    ``name``, ``device_type``, ``time_range`` in µs and
    ``is_user_annotation``)."""

    def __init__(self, events: Iterable):
        self.ranges: Dict[str, List] = defaultdict(list)
        launched, ops = {}, []
        lo = hi = None
        for e in events:
            tr = e.time_range
            lo = tr.start if lo is None else min(lo, tr.start)
            hi = tr.end if hi is None else max(hi, tr.end)
            if _is_device(e):
                if not getattr(e, "is_user_annotation", False):
                    ops.append((tr.start, tr.end, e.id))
            elif e.name in SPANS:
                self.ranges[e.name].append(e)
            elif e.name.startswith(LAUNCH):
                launched[e.id] = tr.start
        # each device operation's duration by the host time of its launch
        by_launch = sorted((launched[i], e - s) for s, e, i in ops
                           if i in launched)
        self._t = [t for t, _ in by_launch]
        self._cum = [0.0] + list(itertools.accumulate(d for _, d in by_launch))
        ops.sort()
        self.busy_us, self.gaps = 0.0, []
        cur_s = cur_e = None
        for s, e, _ in ops:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    self.busy_us += cur_e - cur_s
                    self.gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            self.busy_us += cur_e - cur_s
            self.gaps = ([(lo, ops[0][0])] + self.gaps + [(cur_e, hi)])
            self.gaps = [(a, b) for a, b in self.gaps if b > a]

    def count(self, name: str) -> int:
        return len(self.ranges.get(name, ()))

    def _launched_us(self, start: float, end: float) -> float:
        i = bisect.bisect_left(self._t, start)
        j = bisect.bisect_right(self._t, end)
        return self._cum[j] - self._cum[i]

    def device_ms(self, name: str, skip: Iterable[str] = ()
                  ) -> Optional[float]:
        """Device ms launched inside every ``name`` range, less, with
        ``skip``, inside the ranges of those names nested in one; None
        without such a range or without device time in the span."""
        outer = _bounds(self.ranges.get(name, ()))
        if not outer or self.busy_us <= 0:
            return None
        us = sum(self._launched_us(s, e) for s, e in outer)
        starts = [s for s, _ in outer]
        for s, e in _bounds(r for n in skip for r in self.ranges.get(n, ())):
            k = bisect.bisect_right(starts, s) - 1
            if k >= 0 and outer[k][1] >= e:
                us -= self._launched_us(s, e)
        return 1e-3 * us

    def idle_ms(self) -> Optional[Dict[str, float]]:
        """Idle ms by where the host was at each gap's middle (a
        ``serve.<phase>``, ``serve.step``, or ``OUTSIDE``); None without
        steps or device time."""
        if not self.ranges.get(STEP) or self.busy_us <= 0:
            return None
        phases = sorted((e.time_range.start, e.time_range.end, e.name)
                        for n, es in self.ranges.items()
                        if n.startswith("serve.") and n != STEP
                        for e in es)
        steps = _bounds(self.ranges[STEP])
        p_starts = [p[0] for p in phases]
        s_starts = [s[0] for s in steps]
        out: Dict[str, float] = defaultdict(float)
        for g0, g1 in self.gaps:
            mid = 0.5 * (g0 + g1)
            where = OUTSIDE
            i = bisect.bisect_right(s_starts, mid) - 1
            if i >= 0 and steps[i][1] >= mid:
                where = STEP
                j = bisect.bisect_right(p_starts, mid) - 1
                if j >= 0 and phases[j][1] >= mid:
                    where = phases[j][2]
            out[where] += 1e-3 * (g1 - g0)
        return dict(out)


def of(run) -> Optional[Spans]:
    """The ``Spans`` of a run's traced span (kept per span), or None
    where the run was not traced."""
    prof = getattr(run.driver, "profile", None)
    if prof is None or getattr(prof, "_prof", None) is None:
        return None
    if prof not in _CACHE:
        _CACHE[prof] = Spans(prof._prof.events())
    return _CACHE[prof]


def per_step(run, ms: Optional[float], steps_of: str = STEP
             ) -> Optional[float]:
    """``ms`` over the number of ``steps_of`` ranges in the span."""
    sp = of(run)
    n = sp.count(steps_of) if sp is not None else 0
    return ms / n if ms is not None and n else None

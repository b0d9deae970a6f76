"""Device trace of a steady span under ``torch.profiler``, and the
harness's own labels around the calls it wants to tell apart.

``Profiled`` traces a span (CPU and CUDA activity) and reduces it to:
the seconds some device operation ran (the union of their intervals),
the span's wall seconds, device seconds by operation name, the device
seconds of each ``portbench.*`` label's calls, and the idle gaps between
device operations summed by what the host was running at the gap's
middle (the innermost host operation, or "python" where none was).
"""
from __future__ import annotations

import bisect
import math
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


LABEL = "portbench."


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class CallLog:
    """Products recorded by ``instrument`` while ``active``."""

    def __init__(self):
        self.active = False
        self.step = 0
        self.calls: List[Dict] = []


def instrument(log: CallLog):
    """Label every bitmap product of the program ``portbench.k1`` (one
    weight) or ``portbench.k1g`` (a group stack) and record its shape
    while the log is active.  Returns the function that undoes it."""
    from repro_torch.kernels import ops
    orig1, orig2 = ops.bitmap_spmm, ops.bitmap_spmm_grouped

    def k1(x, w, *a, **kw):
        if log.active:
            log.calls.append({"step": log.step, "grouped": False,
                              "m": math.prod(x.shape[:-1]),
                              "k": w.shape[0], "n": w.shape[1], "g": 1})
        with torch.profiler.record_function("portbench.k1"):
            return orig1(x, w, *a, **kw)

    def k1g(x, w, *a, **kw):
        if log.active:
            log.calls.append({"step": log.step, "grouped": True,
                              "m": x.shape[1], "k": w.shape[0],
                              "n": w.shape[1], "g": x.shape[0]})
        with torch.profiler.record_function("portbench.k1g"):
            return orig2(x, w, *a, **kw)

    ops.bitmap_spmm, ops.bitmap_spmm_grouped = k1, k1g

    def undo():
        ops.bitmap_spmm, ops.bitmap_spmm_grouped = orig1, orig2
    return undo


def warm(device) -> None:
    """Start and stop the profiler once, so that its first start (which
    loads the device tracer, seconds) falls in set-up."""
    with Profiled(device):
        (torch.zeros(8, device=device) + 1).sum().item()


class Profiled:
    """``with Profiled(device) as p: ...``; then ``p.summary``."""

    def __init__(self, device):
        self.device = device
        self.summary: Optional[Dict] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarise(self._prof, wall)
        return False


def summarise(prof, wall_s: float) -> Dict:
    from torch.autograd import DeviceType
    events = prof.events()
    dev, host = [], []
    labels: Dict[str, float] = defaultdict(float)
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a label's span as the device ran it (its first operation's
            # start to its last one's end) is no device operation itself
            if e.name.startswith(LABEL):
                labels[e.name] += (tr.end - tr.start) * 1e-6
            elif not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    busy_us, gaps = 0.0, []
    by_name: Dict[str, float] = defaultdict(float)
    cur_s = cur_e = None
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        label, best = "python", math.inf
        for j in range(i - 1, max(-1, i - 400), -1):
            s, e, name = host[j]
            if e >= mid and e - s < best:
                label, best = name, e - s
        idle[label] += (g1 - g0) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_us * 1e-6, "window_s": wall_s,
            "device_ops": [[n, s] for n, s in top[:10]],
            "idle_gaps": [[n, s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
            "labels": dict(labels)}

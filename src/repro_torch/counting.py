"""The registry an op counter and the kernel entry points share, and
the program's profiler ranges.

``launch/counters.OpCounter`` puts itself on ``_ACTIVE`` while it is
entered.  The kernel layer's entry points (``kernels/ops``,
``kernels/nm_spmm``) are wrapped by ``counted``, which books a call as
one op with the innermost active counter and, with none active, costs
one list check.  This module imports nothing of the package, so the
kernel layer and the launch layer above it both import it.

A counter here is any object with an ``_inside`` depth (non-zero while
it runs a call it is already counting) and a ``kernel_call(name, flops,
operand_bytes, out_shape, out_dtype, device, run)`` method.

``span(name)`` brackets one layer of the program (``SPANS``) as a
profiler record while a profiler runs, so that the layer sits on the
device trace's clock beside the device work launched inside it.  The
record is function-scoped, as an op's is (``_RecordFunctionFast``), not
a user annotation (``record_function``): a kernel launched straight
from it (the hand-written ones, through ``ctypes``) is linked to it, a
caller's own annotations around the program's calls keep their
device-side extents, and it costs less under the profiler.  With no
profiler running ``span`` returns one shared no-op context: one flag
read, no record made (a bare ``record_function`` costs some
microseconds even then).  ``counted`` opens ``kernel.<name>`` around
every entry point.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, List

import torch
import torch.autograd.profiler as _profiler

_ACTIVE: List = []

#: the kernel layer's entry points, each a ``kernel.<name>`` range
KERNELS = ("bitmap_spmm", "bitmap_spmm_grouped", "block_sparse_matmul",
           "flash_attention", "nm_spmm", "decode_attention")
#: the engine step's phases (``serve/telemetry.PHASES``), each a
#: ``serve.<phase>`` range inside ``serve.step``
SERVE_PHASES = ("schedule", "prefill", "page_ensure", "decode",
                "host_sync", "sample", "deadline_sweep", "audit")
#: every range the program opens: the kernel entry points, decode
#: attention (its kernel's range nested), the MoE layer
#: (router to combine, its grouped products nested), the engine step and
#: its phases, a train step's gradients and its update (gradient masks,
#: the optimizer, parameter masks)
SPANS = frozenset(
    [f"kernel.{k}" for k in KERNELS]
    + ["attn.decode", "moe", "serve.step", "train.grads", "train.update"]
    + [f"serve.{p}" for p in SERVE_PHASES])

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler record named ``name`` while a profiler runs, else the
    shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def active():
    """The innermost active counter, or None; None too inside an entry
    point already being counted, so that a call is one op however its
    implementation nests."""
    c = _ACTIVE[-1] if _ACTIVE else None
    return None if c is None or c._inside else c


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor spans: its elements, a broadcast (stride 0) dim
    counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def counted(name: str, charge: Callable) -> Callable:
    """Decorator of a kernel entry point: under an active counter a call
    is one op named ``name``, charged ``charge(counter, *args,
    **kwargs)`` = (flops, operand bytes, result shape, result dtype,
    device); the counter runs the call with nothing inside it counted,
    or, on meta tensors, makes an empty result of that shape.  Every
    call is a ``kernel.<name>`` span."""
    label = f"kernel.{name}"

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(label):
                counter = active()
                if counter is None:
                    return fn(*args, **kwargs)
                return counter.kernel_call(
                    name, *charge(counter, *args, **kwargs),
                    lambda: fn(*args, **kwargs))
        return call
    return wrap

"""The registry an op counter and the kernel entry points share.

``launch/counters.OpCounter`` puts itself on ``_ACTIVE`` while it is
entered.  The kernel layer's entry points (``kernels/ops``,
``kernels/nm_spmm``) are wrapped by ``counted``, which books a call as
one op with the innermost active counter and, with none active, costs
one list check.  This module imports nothing of the package, so the
kernel layer and the launch layer above it both import it.

A counter here is any object with an ``_inside`` depth (non-zero while
it runs a call it is already counting) and a ``kernel_call(name, flops,
operand_bytes, out_shape, out_dtype, device, run)`` method.
"""
from __future__ import annotations

import functools
from typing import Callable, List

import torch

_ACTIVE: List = []


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
    or, on meta tensors, makes an empty result of that shape."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counter = active()
            if counter is None:
                return fn(*args, **kwargs)
            return counter.kernel_call(
                name, *charge(counter, *args, **kwargs),
                lambda: fn(*args, **kwargs))
        return call
    return wrap

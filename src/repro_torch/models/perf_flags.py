"""A/B switch between the reference's baseline lowering and its default.

Port of ``repro/models/perf_flags.py``.  ``REPRO_PERF_MODE=baseline``
selects the reference's pre-optimisation variants.  The port has those
that change values or layout: the global-argsort MoE dispatch (its
capacity counts the whole batch's tokens, not each row's, so it may drop
other tokens), tensor-parallel MoE rules and Adam moments laid out like
the params.  The reference's other two, GQA over materialised repeated
KV heads and the loss chunk without ``checkpoint``, give the default
path's values and differ only in XLA's memory and time on the TPU; the
port has one path for each, held to both of the reference's by tests.

The variable is read once, where a step, an engine or a set of specs is
built, and the choice is passed down from there.  Default: off.
"""
from __future__ import annotations

import os
from typing import Optional


def baseline_mode(flag: Optional[bool] = None) -> bool:
    """``flag`` when it is given, else whether ``REPRO_PERF_MODE`` is
    ``baseline``."""
    if flag is not None:
        return flag
    return os.environ.get("REPRO_PERF_MODE", "").lower() == "baseline"

"""CUDA kernel for Hopper: single-token attention against the slotted KV
cache (the decode step's attention, and chunked prefill's per token).

``decode_attention`` replaces no Pallas kernel: the reference's
``repro/models/layers.py: decode_attention`` is two jnp einsums around a
masked softmax that XLA fuses, with the KV kept in its own type and
float32 accumulation.  ``decode_attention_ref`` is the same function in
plain PyTorch (the CPU's path, and the card's yardstick): it multiplies
float32 copies of every cache line, which on the card cost a float32
copy of both caches per layer and step.  The source is
``csrc/decode_attention.cu`` (plain C entry point), built with the
port's other kernels into one library at first use (``_build``).

Bound: the bytes of the valid K and V lines (about one operation a
byte).  The kernel reads the cache in place, in its type, each valid
line once and no other line; positions are read on the device, so a
call makes no host sync and can be captured in a CUDA graph.  A slot's
valid positions are cut into splits of 256 positions aligned to
multiples of 256; one block per (split, KV head, slot) serves all the KV
head's query heads (up to 16), and a second launch combines the splits of
each slot in a fixed order (none when the cache has one split).  The
source decides the splits and says how much float32 scratch they need.
See the source's header for the rest.

Host cost (the host paces a served step): shapes, types and strides are
checked once per combination (``_plan``, cached); every call checks only
where the tensors lie and that the caches are contiguous and aligned, and
reads the current stream's handle raw (``torch.cuda.current_stream``
builds a ``Stream`` object, several times the cost of the rest of the
checks).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, _build

HEAD_DIMS = (16, 32, 64, 128, 256)
POS_TYPES = {torch.int32: 0, torch.int64: 1}


def valid_lines(pos: torch.Tensor, c: int, window: Optional[int] = None,
                ring: bool = False) -> torch.Tensor:
    """(B, C) bool: the cache lines each slot at ``pos`` ((B,), or a
    scalar for one row) attends to.  Line i holds position i, or with
    ``ring`` the latest position p <= pos with p % C == i; a line is
    valid when 0 <= p <= pos and, with a window, pos - p < window."""
    pc = pos.reshape(-1, 1).to(torch.int64)
    lines = torch.arange(c, device=pos.device)[None, :]
    if ring:
        # cold lines hold p < 0
        base = pc - (pc % c)
        slot_pos = torch.where(lines <= (pc % c), base + lines,
                               base - c + lines)
    else:
        slot_pos = lines
    valid = (slot_pos <= pc) & (slot_pos >= 0)
    if window is not None:
        valid &= (pc - slot_pos) < window
    return valid


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor, *,
                         window: Optional[int] = None,
                         ring: bool = False) -> torch.Tensor:
    """The plain version: q rounded to the cache type, scores and softmax
    over all C lines in float32 (invalid lines at -1e30), p rounded to
    the cache type, the PV product in float32, the output in q's type.
    Shapes as ``decode_attention``."""
    b, c, hkv, d = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qh = q[:, 0].reshape(b, hkv, g, d).to(k_cache.dtype)
    s = torch.einsum("bkgd,bckd->bkgc", qh.float(),
                     k_cache.float()) * scale
    s = s.reshape(b, hq, c)
    valid = valid_lines(pos.expand(b) if pos.dim() == 0 else pos, c,
                        window, ring)
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1).reshape(b, hkv, g, c)
    out = torch.einsum("bkgc,bckd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.entry("decode_attention_launch", p, ll, i, p, p, p, i, i,
                        p, p, ll, *[i] * 7, ctypes.c_float, i)


@functools.lru_cache(maxsize=256)
def _scratch_floats(b: int, c: int, hq: int, d: int, window: int,
                    ring: int) -> int:
    """float32 scratch a call needs (0: one split, one launch), as the
    source sizes its splits."""
    fn = _build.library().decode_attention_scratch
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn(b, c, hq, d, window, ring)


@functools.lru_cache(maxsize=256)
def _plan(q_shape, q_stride, q_dtype, k_shape, k_dtype, v_shape, v_dtype,
          pos_shape, pos_stride, pos_dtype, window, ring) -> tuple:
    """Checks of one combination of shapes, strides and types; the
    launch's arguments that follow from them: (scratch floats, q's batch
    stride and type flag, pos's stride and type flag, the cache's shape
    and type flag, window, ring, scale)."""
    if k_dtype not in _build.TYPE_FLAG or v_dtype != k_dtype:
        raise TypeError(f"the caches must share one type, float32 or "
                        f"bfloat16, got {k_dtype} and {v_dtype}")
    if q_dtype not in _build.TYPE_FLAG:
        raise TypeError(f"q must be float32 or bfloat16, got {q_dtype}")
    if len(k_shape) != 4 or k_shape != v_shape:
        raise ValueError(f"k_cache and v_cache must be one (B, C, Hkv, D) "
                         f"shape, got {tuple(k_shape)} and {tuple(v_shape)}")
    b, c, hkv, d = k_shape
    if len(q_shape) != 4 or q_shape[0] != b or q_shape[1] != 1 \
            or q_shape[3] != d:
        raise ValueError(f"q must be (B, 1, Hq, D) against caches "
                         f"{tuple(k_shape)}, got {tuple(q_shape)}")
    if q_stride[3] != 1 or q_stride[2] != d:
        raise ValueError("q's heads must each be D contiguous elements")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    hq = q_shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} must be a multiple of KV heads "
                         f"{hkv}")
    if not 1 <= b <= 65535 or c < 1:
        raise ValueError(f"B must be in [1, 65535] and C >= 1, got {b}, {c}")
    if pos_dtype not in POS_TYPES or len(pos_shape) > 1 or (
            len(pos_shape) == 1 and pos_shape[0] != b):
        raise ValueError(f"pos must be an int32 / int64 scalar or (B,), got "
                         f"{pos_dtype} {tuple(pos_shape)}")
    if window is not None and not 1 <= window < 2**31:
        raise ValueError(f"window must be a positive int32, got {window}")
    window, ring = window or 0, int(ring)
    return (_scratch_floats(b, c, hq, d, window, ring), q_stride[0],
            _build.TYPE_FLAG[q_dtype], pos_stride[0] if pos_shape else 0,
            POS_TYPES[pos_dtype], b, c, hq, hkv, d, window, ring, d ** -0.5,
            _build.TYPE_FLAG[k_dtype])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """Decode attention on the card: q (B, 1, Hq, D), caches (B, C, Hkv,
    D) float32 or bfloat16, pos a scalar or (B,) int32 / int64 on the
    card -> (B, 1, Hq, D) in q's type.  Launches the CUDA kernel (and,
    with more than one split, its combine) on the current stream, with
    no synchronisation, or raises."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, q on {dev}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    scratch, *args = _plan(q.shape, q.stride(), q.dtype, k_cache.shape,
                           k_cache.dtype, v_cache.shape, v_cache.dtype,
                           pos.shape, pos.stride(), pos.dtype, window, ring)
    q_sb, q_flag, pos_stride, pos_flag, b, c, hq, hkv, d, *rest = args
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=dev)
    part = (torch.empty(scratch, dtype=torch.float32, device=dev)
            if scratch else None)
    rc = _entry()(q.data_ptr(), q_sb, q_flag, k_cache.data_ptr(),
                  v_cache.data_ptr(), pos.data_ptr(), pos_stride, pos_flag,
                  out.data_ptr(), None if part is None else part.data_ptr(),
                  scratch, b, c, hq, hkv, d, *rest,
                  torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check_launch("decode_attention", rc)
    LAUNCHES["decode_attention"] += 1
    return out

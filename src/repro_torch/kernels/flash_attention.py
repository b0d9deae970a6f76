"""CUDA kernel for Hopper: flash attention (online softmax, KV streaming).

``flash_attention`` replaces ``repro/kernels/flash_attention.py:
flash_attention``, the Pallas TPU kernel for causal grouped-query
attention with an optional sliding window.  The source is
``csrc/flash_attention.cu`` (plain C entry point), built with the port's
other kernels into one library at first use (``_build``).

Bound: at the models' sequence lengths the kernel is bound by its
operations (4·D per live score pair), not by the bytes of Q, K, V and
the output.  The design keeps a Q tile in shared memory, streams each
K/V tile into shared memory once per query tile with ``cp.async`` (the
next tile's copy overlapping the current product), and skips the KV
tiles that the causal mask or the window masks wholly.  It uses the FMA
units, not the tensor cores (see the source's header).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

HEAD_DIMS = (32, 64, 128, 256)


def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("flash_attention_launch", *[p] * 4, *[i] * 8,
                        ctypes.c_float, i)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    if not q.is_cuda:
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share one type, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, S, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if q.dtype not in _build.TYPE_FLAG:
        raise TypeError(f"q, k and v must be float32 or bfloat16, got "
                        f"{q.dtype}")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, Hkv, Skv, D) matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"query heads {hq} must be a multiple of KV heads "
                         f"{hkv}")
    if sq < 1 or skv < 1:
        raise ValueError(f"empty sequence: Sq {sq}, Skv {skv}")
    if b * hq > 65535:
        raise ValueError(f"B x Hq must be <= 65535, got {b * hq}")
    if window is not None and not 1 <= window < 2**31:
        raise ValueError(f"window must be a positive int32, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """Attention on the card: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D),
    float32 or bfloat16 -> (B, Hq, Sq, D) in q's type.  Launches the CUDA
    kernel on the current stream (no synchronisation) or raises."""
    _check(q, k, v, window)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, hkv, sq, skv, d, int(causal), window or 0,
                  d ** -0.5, _build.TYPE_FLAG[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out


def live_pairs(sq: int, skv: int, causal: bool = True,
               window: int | None = None) -> int:
    """(query, key) pairs the mask keeps for one head: the score pairs a
    call must compute (its operations are 4·D per pair)."""
    q = torch.arange(sq, dtype=torch.int64)
    hi = q.clamp(max=skv - 1) if causal else torch.full_like(q, skv - 1)
    lo = (q - window + 1).clamp(min=0) if window else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())

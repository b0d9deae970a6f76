"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function here computes what a hand-written kernel computes, with
ordinary tensor ops.  The CPU tests hold the port against the JAX
package through these; on the card they are reached only when a caller
asks for them explicitly (``impl="torch"``), to compare a kernel with.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.format import (BitmapWeight, BlockSparseWeight,
                                       unpack_bitmap, unpack_bitmap_stacked,
                                       unpack_block_sparse)
from repro_torch.sparse.nm import NmWeight, unpack_nm


def _product(x: torch.Tensor, dense: torch.Tensor,
             out_dtype: torch.dtype | None) -> torch.Tensor:
    """The weight rounded to ``x.dtype``, the product accumulated in
    float32, cast to ``out_dtype`` (default ``x.dtype``): what every
    sparse product kernel computes once its weight is decompressed."""
    return (x.float() @ dense.to(x.dtype).float()).to(out_dtype or x.dtype)


def bitmap_spmm_ref(x: torch.Tensor, w: BitmapWeight,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of ``bitmap_spmm``: decompress W, round it to
    ``x.dtype``, multiply with float32 accumulation, cast to
    ``out_dtype`` (default ``x.dtype``).  A pack-time ``dense_cache``
    stands in for the decompression when present, as in the reference.
    """
    return _product(x, w.dense_cache if w.dense_cache is not None
                    else unpack_bitmap(w), out_dtype)


def bitmap_spmm_grouped_ref(x: torch.Tensor, w: BitmapWeight,
                            out_dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
    """Plain version of ``bitmap_spmm_grouped``: x (G, M, K), W
    group-stacked -> (G, M, N).  Per group: decompress, round to
    ``x.dtype``, multiply with float32 accumulation, cast to
    ``out_dtype`` (default ``x.dtype``); a ``dense_cache`` stands in for
    the decompression when present."""
    return _product(x, w.dense_cache if w.dense_cache is not None
                    else unpack_bitmap_stacked(w), out_dtype)


def block_sparse_matmul_ref(x: torch.Tensor, w: BlockSparseWeight,
                            out_dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
    """Plain version of ``block_sparse_matmul``: unpack W, round it to
    ``x.dtype``, multiply with float32 accumulation, cast to
    ``out_dtype`` (default ``x.dtype``)."""
    return _product(x, unpack_block_sparse(w), out_dtype)


def nm_spmm_ref(x: torch.Tensor, w: NmWeight,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of ``nm_spmm``: unpack W, round it to ``x.dtype``,
    multiply with float32 accumulation, cast to ``out_dtype`` (default
    ``x.dtype``)."""
    return _product(x, unpack_nm(w), out_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None
                  ) -> torch.Tensor:
    """Plain version of ``flash_attention``: dense masked attention with
    GQA (KV heads repeated), q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D).
    Scores and softmax in float32, masked scores -1e30, output in q's
    type."""
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = (q.float() @ k.float().transpose(-1, -2)) * (d ** -0.5)
    q_pos = torch.arange(q.shape[2], device=q.device)[:, None]
    k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = s.masked_fill(~mask, -1e30)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)

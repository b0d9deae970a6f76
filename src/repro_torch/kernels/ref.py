"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function here computes what a hand-written kernel computes, with
ordinary tensor ops.  The CPU tests hold the port against the JAX
package through these; on the card they are reached only when a caller
asks for them explicitly (``impl="torch"``), to compare a kernel with.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.format import (BitmapWeight, unpack_bitmap,
                                       unpack_bitmap_stacked)


def bitmap_spmm_ref(x: torch.Tensor, w: BitmapWeight,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of ``bitmap_spmm``: decompress W, round it to
    ``x.dtype``, multiply with float32 accumulation, cast to
    ``out_dtype`` (default ``x.dtype``).  A pack-time ``dense_cache``
    stands in for the decompression when present, as in the reference.
    """
    dense = (w.dense_cache if w.dense_cache is not None
             else unpack_bitmap(w)).to(x.dtype)
    return (x.float() @ dense.float()).to(out_dtype or x.dtype)


def bitmap_spmm_grouped_ref(x: torch.Tensor, w: BitmapWeight,
                            out_dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
    """Plain version of ``bitmap_spmm_grouped``: x (G, M, K), W
    group-stacked -> (G, M, N).  Per group: decompress, round to
    ``x.dtype``, multiply with float32 accumulation, cast to
    ``out_dtype`` (default ``x.dtype``); a ``dense_cache`` stands in for
    the decompression when present."""
    dense = (w.dense_cache if w.dense_cache is not None
             else unpack_bitmap_stacked(w)).to(x.dtype)
    return torch.bmm(x.float(), dense.float()).to(out_dtype or x.dtype)

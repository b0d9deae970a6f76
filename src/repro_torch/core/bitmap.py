"""Bitmap sparse format (paper Fig. 1).

A vector/matrix is stored as (bitmap, compressed values): the bitmap marks
non-zero positions in original order; values are the non-zeros packed densely
("inside buffer" in the paper).  All simulator-side code is numpy (the
accelerator model runs on the host); jnp variants used by the framework live
in ``repro.sparse``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class BitmapVector:
    """One buffer row: bitmap over original indexes + packed non-zero values."""

    bitmap: np.ndarray  # (K,) bool
    values: np.ndarray  # (nnz,) packed non-zeros in original order

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def k(self) -> int:
        return int(self.bitmap.shape[0])

    def decompress(self) -> np.ndarray:
        out = np.zeros(self.k, dtype=self.values.dtype)
        out[self.bitmap] = self.values
        return out


def compress(x: np.ndarray) -> BitmapVector:
    """Compress a 1-D vector to bitmap format."""
    x = np.asarray(x)
    bitmap = x != 0
    return BitmapVector(bitmap=bitmap, values=x[bitmap])


def compress_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compress each row of a 2-D matrix.

    Returns (bitmap (M, K) bool, values (M, max_nnz) zero-padded,
    nnz (M,) int32).  Padded layout keeps the simulator fully vectorised.
    """
    x = np.asarray(x)
    bitmap = x != 0
    nnz = bitmap.sum(axis=-1).astype(np.int32)
    max_nnz = int(nnz.max()) if x.size else 0
    m, k = x.shape
    values = np.zeros((m, max(max_nnz, 1)), dtype=x.dtype)
    # rank of each non-zero inside its row = its compressed index
    ranks = np.cumsum(bitmap, axis=-1) - 1
    rows, cols = np.nonzero(bitmap)
    values[rows, ranks[rows, cols]] = x[rows, cols]
    return bitmap, values, nnz


def mask_index(bitmap: np.ndarray) -> np.ndarray:
    """Paper's IMId / WMId: original index of each compressed element.

    ``mask_index(bm)[j]`` = original position of the j-th non-zero.  Rows with
    fewer non-zeros are padded with K (out of range sentinel).
    """
    bitmap = np.asarray(bitmap, dtype=bool)
    if bitmap.ndim == 1:
        return np.nonzero(bitmap)[0]
    m, k = bitmap.shape
    nnz = bitmap.sum(-1)
    out = np.full((m, int(nnz.max()) if m else 0), k, dtype=np.int64)
    ranks = np.cumsum(bitmap, axis=-1) - 1
    rows, cols = np.nonzero(bitmap)
    out[rows, ranks[rows, cols]] = cols
    return out


def random_sparse(shape, sparsity: float, rng: np.random.Generator,
                  dtype=np.float32) -> np.ndarray:
    """Dense array with ~``sparsity`` fraction of exact zeros (unstructured)."""
    dense = rng.standard_normal(shape).astype(dtype)
    mask = rng.random(shape) >= sparsity
    return dense * mask


def prune_global_l1(w: np.ndarray, sparsity: float) -> np.ndarray:
    """Global L1 fine-grained magnitude pruning (Han et al. [1], as in paper)."""
    if sparsity <= 0:
        return w
    flat = np.abs(w).ravel()
    k = int(round(sparsity * flat.size))
    if k <= 0:
        return w
    thresh = np.partition(flat, k - 1)[k - 1]
    return np.where(np.abs(w) <= thresh, 0.0, w).astype(w.dtype)

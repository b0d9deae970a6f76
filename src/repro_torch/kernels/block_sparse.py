"""CUDA kernel for Hopper: dense × block-sparse product.

``block_sparse_matmul`` replaces ``repro/kernels/block_sparse.py:
block_sparse_matmul``, the Pallas TPU kernel that multiplies only the
weight's surviving (BK, BN) blocks (``kidx``, ``nnzb``).  The source is
``csrc/block_sparse.cu``, on the tile product shared with N:M
(``csrc/tile_product.cuh``), built with the port's other kernels into
one library at first use (``_build``).

Paths (``tile_product.plan``): bf16 X at wide M runs the surviving
blocks on the tensor cores (``mma.sync``, 128-row tiles, a three-stage
``cp.async`` ring of bf16 X and weight blocks), bound by their
multiply-adds; bf16 X at decode M runs a two-stage ring with 8-row
tiles, bound by the surviving blocks' bytes; float32 X keeps the float32 FMA
path.  Each block of threads loads its own indices and walks only its
column block's surviving blocks; where too few blocks would fill the
card, that walk is split across blocks, balanced by surviving blocks,
with a fixed-order second pass (see the source's header).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.tile_product import (PATH_FLAG, Plan,
                                              check_operands, plan,
                                              tile_splits)
from repro_torch.sparse.format import BlockSparseWeight


def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("block_sparse_launch", *[p] * 6, *[i] * 12)


def block_sparse_matmul(x: torch.Tensor, w: BlockSparseWeight,
                        out_dtype: torch.dtype | None = None,
                        p: Plan | None = None) -> torch.Tensor:
    """``x @ W`` on the card: x (M, K) float32 or bfloat16 -> (M, N) in
    ``out_dtype`` (default ``x.dtype``).  Launches the CUDA kernel on the
    current stream (no synchronisation) or raises.  ``p`` is the path
    and row tile, ``tile_product.plan``'s unless a caller comparing paths
    names another."""
    k, n = w.shape
    bk, bn = w.block
    nt = n // bn
    if (tuple(w.values.shape) != (nt, w.smax, bk, bn)
            or tuple(w.kidx.shape) != (nt, w.smax)
            or tuple(w.nnzb.shape) != (nt,)):
        raise ValueError("values / kidx / nnzb shapes disagree with the "
                         "weight's shape and block")
    if w.kidx.dtype != torch.int32 or w.nnzb.dtype != torch.int32:
        raise TypeError("kidx and nnzb must be int32")
    out_dtype = check_operands(
        "block_sparse_matmul", x,
        {"values": w.values, "kidx": w.kidx, "nnzb": w.nnzb}, w.shape,
        w.block, out_dtype)
    m = x.shape[0]
    p = p or plan(m, x.dtype, bk)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    splits = tile_splits(w.smax, nt, m, _build.sm_count(x.device), p)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    rc = _entry()(x.data_ptr(), w.values.data_ptr(), w.kidx.data_ptr(),
                  w.nnzb.data_ptr(), out.data_ptr(),
                  partial.data_ptr() if partial is not None else None, m, k,
                  n, bk, bn, w.smax, splits, PATH_FLAG[p.path], p.rows,
                  _build.TYPE_FLAG[x.dtype], _build.TYPE_FLAG[w.values.dtype],
                  _build.TYPE_FLAG[out_dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("block_sparse_matmul", rc)
    LAUNCHES["block_sparse_matmul"] += 1
    return out

"""CUDA kernel for Hopper: dense × N:M-structured-sparse product.

``nm_spmm`` replaces ``repro/kernels/nm_spmm.py:nm_spmm``, the Pallas TPU
kernel that decompresses each (BK, BN) tile of an ``NmWeight`` (kept
values and their int8 offsets within each group of M along K) and
multiplies it.  The source is ``csrc/nm_spmm.cu``, on the tile product
shared with the block-sparse kernel (``csrc/tile_product.cuh``), built
with the port's other kernels into one library at first use
(``_build``).  The JAX package has no ``ops`` entry for N:M, so the
dispatch between the kernel and its plain version lives here.

Paths (``tile_product.plan``): bf16 X at wide M decompresses each K
tile once per 128-row tile, straight into a bf16 stage (a scatter of
the kept values into zeroed groups, loaded one stage ahead), and runs
it on the tensor cores, bound by the dense tile's multiply-adds; bf16 X at
decode M builds no dense tile and walks the kept values (EIM), bound by
their bytes (values + one index byte each), its K tiles split across
blocks with a fixed-order second pass; float32 X keeps the float32 FMA
path (see the source's header).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.counting import counted
from repro_torch.kernels import LAUNCHES, _build, ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.tile_product import (PATH_FLAG, Plan,
                                              check_operands, plan,
                                              tile_splits)
from repro_torch.sparse.nm import NmWeight


def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("nm_spmm_launch", *[p] * 5, *[i] * 13)


def nm_spmm_cuda(x: torch.Tensor, w: NmWeight,
                 out_dtype: torch.dtype | None = None,
                 p: Plan | None = None) -> torch.Tensor:
    """``x @ W`` on the card: x (M, K) float32 or bfloat16 -> (M, N) in
    ``out_dtype`` (default ``x.dtype``).  Launches the CUDA kernel on the
    current stream (no synchronisation) or raises.  ``p`` is the path
    and row tile, ``tile_product.plan``'s unless a caller comparing paths
    names another."""
    k, n = w.shape
    bk, bn = w.block
    kt, nt = k // bk, n // bn
    nk, mg = w.n_keep, w.m_group
    if not (1 <= nk <= 4 and nk <= mg <= 8) or bk % mg:
        raise ValueError(f"{nk}:{mg} with BK {bk}: need 1 <= N <= 4, "
                         f"N <= M <= 8, BK % M == 0")
    packed = (kt, nt, bk // mg * nk, bn)
    if tuple(w.values.shape) != packed or tuple(w.idx.shape) != packed:
        raise ValueError(f"values / idx must be {packed}, got "
                         f"{tuple(w.values.shape)} / {tuple(w.idx.shape)}")
    if w.idx.dtype != torch.int8:
        raise TypeError(f"idx must be int8, got {w.idx.dtype}")
    out_dtype = check_operands("nm_spmm", x,
                               {"values": w.values, "idx": w.idx}, w.shape,
                               w.block, out_dtype)
    if w.idx.data_ptr() % 8:   # read in 8-byte loads
        raise ValueError("idx must be 8-byte aligned")
    m = x.shape[0]
    p = p or plan(m, x.dtype, bk)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    splits = tile_splits(kt, nt, m, _build.sm_count(x.device), p)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    rc = _entry()(x.data_ptr(), w.values.data_ptr(), w.idx.data_ptr(),
                  out.data_ptr(),
                  partial.data_ptr() if partial is not None else None, m, k,
                  n, bk, bn, nk, mg, splits, PATH_FLAG[p.path], p.rows,
                  _build.TYPE_FLAG[x.dtype], _build.TYPE_FLAG[w.values.dtype],
                  _build.TYPE_FLAG[out_dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("nm_spmm", rc)
    LAUNCHES["nm_spmm"] += 1
    return out


@counted("nm_spmm", ops.product_charge)
def nm_spmm(x: torch.Tensor, w: NmWeight, impl: str | None = None,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ W`` with W N:M-compressed; x may be (..., K).  A CUDA
    tensor launches the kernel (or raises), a CPU tensor takes the plain
    version; ``impl="torch"`` asks for the plain version on any device
    (the dispatch of ``ops``)."""
    return ops.flat_product(x, w, impl, nm_spmm_cuda, _ref.nm_spmm_ref,
                            out_dtype)

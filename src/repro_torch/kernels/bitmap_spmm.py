"""CUDA kernel for Hopper: dense × bitmap-compressed-sparse product (EIM).

``bitmap_spmm`` replaces ``repro/kernels/bitmap_spmm.py:bitmap_spmm``, the
Pallas TPU kernel that carries every packed projection and the LM head of
the serving decode step.  ``bitmap_spmm_grouped`` replaces
``repro/kernels/bitmap_spmm.py:bitmap_spmm_grouped`` (MoE expert stacks),
which unrolls one TPU kernel call per group: here one launch covers every
group, the group folded into the grid.  The source is
``csrc/bitmap_spmm.cu`` (plain C entry points), built with the port's
other kernels into one library at first use (``_build``).

Bound: at decode M (1..8 rows) each weight byte feeds at most eight
multiply-adds, so the kernel is bound by the compressed weight bytes
(bitmap + values + row starts) it streams from device memory, not by
arithmetic.  The design reads every weight byte once per 8 rows of X,
copies each tile's values to shared memory with all its loads in flight
at once (``cp.async``), and splits K across blocks so that a decode
step's narrow outputs still fill the card; the wrapper picks the split
from the card's SM count (see the source's header for the rest).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.sparse.format import BitmapWeight


def _entry(grouped: bool = False):
    """K1's entry point, or with ``grouped`` K1g's."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if grouped:
        return _build.entry("bitmap_spmm_grouped_launch", *[p] * 6, *[i] * 11)
    return _build.entry("bitmap_spmm_launch", *[p] * 6, *[i] * 10)


def k_splits(kt: int, nt: int, m: int, sms: int, groups: int = 1,
             rows: int = 8) -> int:
    """How many blocks share the K tiles of one (group, column tile,
    block of ``rows`` rows): enough for about four blocks per SM (two run
    at once, the rest queue behind them), at most one per K tile.  More
    splits mean more float32 partial sums to add."""
    blocks = groups * nt * -(-m // rows)
    return max(1, min(kt, -(-4 * sms // blocks)))


def _check(x: torch.Tensor, w: BitmapWeight,
           grouped: bool = False) -> Tuple[int, int, int, int]:
    """Validate one call: x (M, K) and one matrix, or, ``grouped``,
    x (G, M, K) and a group-stacked weight."""
    name = "bitmap_spmm_grouped" if grouped else "bitmap_spmm"
    if not x.is_cuda:
        raise ValueError(f"{name} kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if grouped:
        if x.dim() != 3 or w.values.dim() != 4:
            raise ValueError(f"x must be (G, M, K) and the weight "
                             f"group-stacked, got x {tuple(x.shape)} and "
                             f"values {tuple(w.values.shape)}")
        if x.shape[0] != w.values.shape[0]:
            raise ValueError(f"x has G={x.shape[0]} groups, the weight "
                             f"{w.values.shape[0]}")
        if x.shape[0] * -(-x.shape[1] // 8) > 65535:   # grid z
            raise ValueError(f"G x ceil(M / 8) must be <= 65535, got "
                             f"x {tuple(x.shape)}")
    else:
        if x.dim() != 2 or x.shape[0] > 8 * 65535:   # 8-row blocks on z
            raise ValueError(f"x must be (M, K) with M <= {8 * 65535}, "
                             f"got {tuple(x.shape)}")
        if w.values.dim() != 3:
            raise ValueError(f"one (K, N) matrix expected, got values of "
                             f"shape {tuple(w.values.shape)} (slice a "
                             f"stacked weight)")
    if not {x.dtype, w.values.dtype} <= _build.TYPE_FLAG.keys():
        raise TypeError(f"x and values must be float32 or bfloat16, got "
                        f"{x.dtype} and {w.values.dtype}")
    if w.packed_bits.dtype != torch.uint8 or w.row_start.dtype != torch.int32:
        raise TypeError("packed_bits must be uint8 and row_start int32")
    for name, t in (("x", x), ("packed_bits", w.packed_bits),
                    ("values", w.values), ("row_start", w.row_start)):
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    k, n = w.shape
    bk, bn = w.block
    lead = (x.shape[0],) if grouped else ()
    kt, nt = w.packed_bits.shape[len(lead):len(lead) + 2]
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, W is {w.shape}")
    if bn % 8 or not (1 <= bk <= 128 and 8 <= bn <= 128):
        raise ValueError(f"block {w.block}: need BK <= 128, 8 <= BN <= 128, "
                         f"BN % 8 == 0")
    if kt * bk != k or nt * bn != n:
        raise ValueError(f"tile grid {(kt, nt)} x block {w.block} does not "
                         f"cover {w.shape}")
    if tuple(w.packed_bits.shape) != lead + (kt, nt, bk, bn // 8) or tuple(
            w.row_start.shape) != lead + (kt, nt, bk) or tuple(
            w.values.shape[:-1]) != lead + (kt, nt):
        raise ValueError("packed_bits / values / row_start shapes disagree")
    return kt, nt, bk, bn


def bitmap_spmm(x: torch.Tensor, w: BitmapWeight,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ W`` on the card: x (M, K) float32 or bfloat16 -> (M, N) in
    ``out_dtype`` (default ``x.dtype``).  Launches the CUDA kernel on the
    current stream (no synchronisation) or raises."""
    kt, nt, bk, bn = _check(x, w)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _build.TYPE_FLAG:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    m = x.shape[0]
    out = torch.empty((m, nt * bn), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    splits = k_splits(kt, nt, m, _build.sm_count(x.device))
    partial = (torch.empty((splits, m, nt * bn), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = _entry()
    rc = fn(x.data_ptr(), w.packed_bits.data_ptr(), w.values.data_ptr(),
            w.row_start.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None, m, kt, nt,
            bk, bn, w.budget, splits, _build.TYPE_FLAG[x.dtype],
            _build.TYPE_FLAG[w.values.dtype], _build.TYPE_FLAG[out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("bitmap_spmm", rc)
    LAUNCHES["bitmap_spmm"] += 1
    return out


def bitmap_spmm_grouped(x: torch.Tensor, w: BitmapWeight,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """``x[g] @ W_g`` for every group on the card, in one launch: x
    (G, M, K) float32 or bfloat16, W group-stacked (leaves (G, KT, NT,
    ...), one budget) -> (G, M, N) in ``out_dtype`` (default
    ``x.dtype``).  Launches on the current stream or raises."""
    kt, nt, bk, bn = _check(x, w, grouped=True)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _build.TYPE_FLAG:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    g, m, _ = x.shape
    out = torch.empty((g, m, nt * bn), dtype=out_dtype, device=x.device)
    if m == 0 or g == 0:
        return out
    splits = k_splits(kt, nt, m, _build.sm_count(x.device), groups=g)
    partial = (torch.empty((splits, g, m, nt * bn), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = _entry(grouped=True)
    rc = fn(x.data_ptr(), w.packed_bits.data_ptr(), w.values.data_ptr(),
            w.row_start.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None, g, m, kt,
            nt, bk, bn, w.budget, splits, _build.TYPE_FLAG[x.dtype],
            _build.TYPE_FLAG[w.values.dtype], _build.TYPE_FLAG[out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("bitmap_spmm_grouped", rc)
    LAUNCHES["bitmap_spmm_grouped"] += 1
    return out


def hbm_traffic_model(x_shape: Tuple[int, ...], w: BitmapWeight,
                      bm: int = 128, itemsize: int = 2) -> dict:
    """Analytic HBM bytes of one bitmap_spmm call vs its dense equivalent
    (a copy of the reference's model: activations re-fetched once per
    output-column block, weights once per output-row block, outputs
    written once).  A grouped call (x_shape (G, M, K), W group-stacked)
    is G calls of one group's shape: its activation and output terms
    scale by G, and ``w.hbm_bytes`` already counts every group."""
    *lead, m, k = x_shape
    groups = lead[0] if lead else 1
    _, n = w.shape
    nt = n // w.block[1]
    mt = max(1, -(-m // bm))
    x_bytes = groups * m * k * itemsize * nt
    out_bytes = groups * m * n * itemsize
    w_sparse = w.hbm_bytes * mt
    w_dense = w.dense_bytes * mt
    return {
        "sparse_bytes": x_bytes + out_bytes + w_sparse,
        "dense_bytes": x_bytes + out_bytes + w_dense,
        "weight_compression": w.compression,
        "components": {
            "x_bytes": x_bytes,
            "out_bytes": out_bytes,
            "w_sparse_bytes": w_sparse,
            "w_dense_bytes": w_dense,
            "col_blocks": nt,
            "row_blocks": mt,
        },
    }

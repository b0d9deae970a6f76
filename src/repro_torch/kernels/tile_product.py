"""Host side of the dense-X × sparse-W tile products (``csrc/
tile_product.cuh``), shared by the block-sparse (K3) and N:M (K4)
wrappers: the row tile, the K split and the operand checks.

The row tile is chosen here and only here: 8 rows of X per block at
decode M, 64 above ``WIDE_ROWS``.  The wrappers pass it to their entry
points, which take no other value.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_spmm import k_splits

WIDE_ROWS = 16   # above this many rows of X, 64-row tiles; else 8-row tiles


def row_tile(m: int) -> int:
    """Rows of X per block of threads for an M-row call."""
    return 64 if m > WIDE_ROWS else 8


def tile_splits(k_tiles: int, col_tiles: int, m: int, sms: int) -> int:
    """``k_splits`` for the tile products' row tile."""
    return k_splits(k_tiles, col_tiles, m, sms, rows=row_tile(m))


def check_operands(name: str, x: torch.Tensor, tensors, shape, block,
                   out_dtype) -> torch.dtype:
    """Checks shared by the tile-product wrappers: x (M, K)
    float32/bfloat16 on the card, the weight's tensors beside it and
    contiguous, a tile grid the kernel takes.
    Returns the output type."""
    if not x.is_cuda:
        raise ValueError(f"{name} kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be (M, K) with M >= 1, got "
                         f"{tuple(x.shape)}")
    if x.shape[0] > 8 * 65535:
        raise ValueError(f"M must be <= {8 * 65535}, got {x.shape[0]}")
    if x.shape[1] != shape[0]:
        raise ValueError(f"x has K={x.shape[1]}, W is {shape}")
    out_dtype = out_dtype or x.dtype
    for t in (x, tensors["values"]):
        if t.dtype not in _build.TYPE_FLAG:
            raise TypeError(f"x and values must be float32 or bfloat16, got "
                            f"{x.dtype} and {tensors['values'].dtype}")
    if out_dtype not in _build.TYPE_FLAG:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    for tname, t in {"x": x, **tensors}.items():
        if t.device != x.device:
            raise ValueError(f"{tname} lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    if tensors["values"].data_ptr() % 16:   # read in 16-byte loads
        raise ValueError("values must be 16-byte aligned")
    bk, bn = block
    if not (1 <= bk <= 128 and 32 <= bn <= 128 and bn % 32 == 0):
        raise ValueError(f"block {block}: need BK <= 128, 32 <= BN <= 128, "
                         f"BN % 32 == 0")
    if shape[0] % bk or shape[1] % bn:
        raise ValueError(f"block {block} does not tile {shape}")
    return out_dtype

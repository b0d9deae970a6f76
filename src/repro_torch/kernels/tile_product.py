"""Host side of the dense-X × sparse-W tile products (``csrc/
tile_product.cuh``), shared by the block-sparse (K3) and N:M (K4)
wrappers: the path and row tile of a call, its K split and the operand
checks.

The path and row tile are chosen here and only here (``plan``):
- ``"tensor"``: bf16 X above ``WIDE_ROWS`` rows, 128-row tiles on the
  tensor cores (``mma.sync``), bf16 tiles through a ``cp.async`` ring;
  bound by the multiply-adds;
- ``"decode"``: bf16 X at up to ``WIDE_ROWS`` rows, 8-row tiles; bound by
  the weight bytes (K3: ``mma.sync`` on zero-padded 16-row fragments;
  K4: the kept values walked one by one, no dense tile);
- ``"fma"``: float32 X (which the plain versions compute in full float32,
  so TF32 tensor cores would change the numbers) or a BK that is not 16,
  32, 64 or 128 (the bf16 paths stack 128 / BK K tiles in a 128-deep
  stage): float32 tiles on the FMA units, 8-row tiles at decode M, 64
  above.
The wrappers pass the plan to their entry points, which refuse a row
tile that is not the path's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

WIDE_ROWS = 16   # above this many rows of X, wide tiles; else 8-row tiles
PATH_FLAG = {"fma": 0, "tensor": 1, "decode": 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str    # a key of PATH_FLAG
    rows: int    # rows of X per block of threads


def plan(m: int, x_dtype: torch.dtype, bk: int) -> Plan:
    """Path and row tile of an M-row call with X of ``x_dtype`` and
    K tiles BK deep."""
    if x_dtype == torch.bfloat16 and bk in (16, 32, 64, 128):
        return Plan("tensor", 128) if m > WIDE_ROWS else Plan("decode", 8)
    return Plan("fma", 64 if m > WIDE_ROWS else 8)


def tile_splits(k_steps: int, col_tiles: int, m: int, sms: int,
                p: Plan) -> int:
    """How many blocks share the K steps (K tiles, or surviving blocks)
    of one column tile and row tile, at most one per step.  The tensor
    path holds one block per SM (its ring takes up to 136 KB of shared
    memory), so it aims at one block per SM; the others at about four, of
    which two run at once and the rest queue.  More splits mean more
    float32 partial sums to add."""
    blocks = col_tiles * -(-m // p.rows)
    per_sm = 1 if p.path == "tensor" else 4
    return max(1, min(k_steps, -(-per_sm * sms // blocks)))


def check_operands(name: str, x: torch.Tensor, tensors, shape, block,
                   out_dtype) -> torch.dtype:
    """Checks shared by the tile-product wrappers: x (M, K)
    float32/bfloat16, a tile grid the kernel takes, then x on the card,
    the weight's tensors beside it, contiguous, values (and bf16 x)
    aligned for 16-byte loads.  Returns the output type."""
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
    bk, bn = block
    if not (1 <= bk <= 128 and 32 <= bn <= 128 and bn % 32 == 0):
        raise ValueError(f"block {block}: need BK <= 128, 32 <= BN <= 128, "
                         f"BN % 32 == 0")
    if shape[0] % bk or shape[1] % bn:
        raise ValueError(f"block {block} does not tile {shape}")
    if not x.is_cuda:
        raise ValueError(f"{name} kernel needs a CUDA tensor, got "
                         f"{x.device}")
    for tname, t in {"x": x, **tensors}.items():
        if t.device != x.device:
            raise ValueError(f"{tname} lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    if tensors["values"].data_ptr() % 16:   # read in 16-byte loads
        raise ValueError("values must be 16-byte aligned")
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:   # cp.async
        raise ValueError("bfloat16 x must be 16-byte aligned")
    return out_dtype

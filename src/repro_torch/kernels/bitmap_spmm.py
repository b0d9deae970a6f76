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
arithmetic.  The design walks the flat list of weight tiles with a
persistent grid, each block a near-equal range of whole chunks of it,
its tiles brought into a ring of shared-memory stages by bulk copies
(the copy engine) and walked by the block's warps; a K range split
between blocks is added by the last block to arrive, in block order,
within the same launch (see the source's header).  The call's plan
(rows of X per tile, block size, ring depth, grid, stage layout,
scratch) is made here: ``stream_plan``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.sparse.format import BitmapWeight

THREADS = (256, 512)         # threads per block: many tiles, few
MAX_DYN_BYTES = 232448 - 1024   # the kernel's dynamic shared memory cap
# Largest cluster the plan forms: clusters of 12 blocks sped granite's
# 12-tile K ranges up, clusters of 16 slowed olmo-1b's (PERF.md, PR 15).
MAX_CLUSTER = 12


def _entry(grouped: bool = False):
    """K1's entry point, or with ``grouped`` K1g's."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if grouped:
        return _build.entry("bitmap_spmm_grouped_launch", *[p] * 7,
                            *[i] * 22)
    return _build.entry("bitmap_spmm_launch", *[p] * 7, *[i] * 21)


def row_tile(m: int) -> int:
    """Rows of X per tile: 4 at up to four rows (the decode step), else
    8."""
    return 4 if m <= 4 else 8


def _up16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """One call's launch plan (see ``stream_plan``)."""
    rows: int          # rows of X per tile (the kernel's MR)
    bn: int            # columns of a tile
    threads: int       # threads per block
    tiles: int         # weight tiles walked: G x row blocks x NT x KT
    outputs: int       # output tiles: G x row blocks x NT (one counter each)
    blocks: int        # persistent blocks, each a range of whole chunks
    chunk: int         # tiles per chunk (divides KT)
    stages: int        # ring stages per block
    stage_bytes: int   # one ring stage: values, bitmap, row starts, X
    off_bits: int
    off_rs: int
    off_x: int
    scratch: int       # after the ring: see ``scratch_bytes``
    cluster: int = 1   # > 1: an output tile's KT blocks form a cluster

    @property
    def smem(self) -> int:
        """Dynamic shared memory: the ring, then the scratch."""
        return self.stages * self.stage_bytes + self.scratch

    @property
    def partial_floats(self) -> int:
        """float32 scratch: two partial output tiles per block (its first
        and last output tile, when another block shares their K range);
        none when clusters add the partials in shared memory."""
        if self.blocks == 1 or self.cluster > 1:
            return 0
        return 2 * self.blocks * self.rows * self.bn


def scratch_bytes(bk: int, bn: int, rows: int, threads: int) -> int:
    """Shared memory after the ring: the warps' float32 sums of four rows
    of X (an output tile's 8 rows are added in two passes), the tile's X
    slice widened to float32, the dense walk's word starts (one int per
    bitmap word), and the block's float32 partial for a cluster."""
    return (4 * (threads // 32) * 4 * bn + 4 * rows * bk + 16 * bk
            + 4 * rows * bn)


def stage_layout(budget: int, vbytes: int, bk: int, bn: int, rows: int,
                 xbytes: int) -> Tuple[int, int, int, int]:
    """(stage bytes, bitmap offset, row-start offset, X offset) of one
    ring stage.  The values, the bitmap and the row starts take their
    16-byte-aligned copy windows (up to 15 bytes more than their own);
    X's slice is ``rows`` rows of the tile's K in X's type."""
    off_bits = _up16(budget * vbytes + 15)
    off_rs = off_bits + _up16(bk * (bn // 8) + 15)
    off_x = off_rs + _up16(4 * bk + 15)
    return off_x + _up16(rows * bk * xbytes), off_bits, off_rs, off_x


def range_start(p: StreamPlan, b: int) -> int:
    """First tile of block ``b``'s range: whole chunks, as equal in number
    as they divide (the kernel's ``range_start``)."""
    return p.tiles // p.chunk * b // p.blocks * p.chunk


def block_of(p: StreamPlan, t: int) -> int:
    """The block whose range holds tile ``t`` (the kernel's ``block_of``)."""
    return ((t // p.chunk + 1) * p.blocks - 1) // (p.tiles // p.chunk)


def chunk_size(tiles: int, kt: int, slots: int) -> int:
    """Tiles per chunk of the blocks' ranges: the largest divisor of KT
    whose chunks still share the tiles among ``slots`` blocks within an
    eighth of an equal share (or one tile).  Whole K ranges per block
    need no fold of partial sums; small chunks balance the blocks."""
    for c in range(kt, 0, -1):
        if kt % c:
            continue
        chunks = tiles // c
        most = -(-chunks // min(slots, chunks)) * c
        if c == 1 or most <= 1.125 * tiles / min(slots, tiles):
            return c
    return 1


def plan_with(groups: int, m: int, kt: int, nt: int, bk: int, bn: int,
              budget: int, vbytes: int, xbytes: int, sms: int, per_sm,
              threads: int, stages: int) -> StreamPlan | None:
    """The plan of one call with blocks of ``threads`` threads and a ring
    of ``stages`` stages, or None when such a block does not fit on an
    SM.  ``per_sm(rows, threads, smem)`` says how many blocks of the
    variant fit on an SM (the card's occupancy), ``sms`` how many SMs the
    card has.  The grid is as many blocks as fit on the card, at most one
    per chunk of tiles."""
    rows = row_tile(m)
    tiles = groups * -(-m // rows) * nt * kt
    stage, off_bits, off_rs, off_x = stage_layout(budget, vbytes, bk, bn,
                                                  rows, xbytes)
    scratch = scratch_bytes(bk, bn, rows, threads)
    smem = stages * stage + scratch
    fit = per_sm(rows, threads, smem) if smem <= MAX_DYN_BYTES else 0
    if fit < 1:
        return None
    chunk = chunk_size(tiles, kt, sms * fit)
    return StreamPlan(rows, bn, threads, tiles, tiles // kt,
                      min(tiles // chunk, sms * fit), chunk, stages, stage,
                      off_bits, off_rs, off_x, scratch)


def stream_plan(groups: int, m: int, kt: int, nt: int, bk: int, bn: int,
                budget: int, vbytes: int, xbytes: int, sms: int, per_sm,
                clusters=None) -> StreamPlan:
    """The plan of one call (see ``plan_with``), the rule measured on an
    H100 (PERF.md, PR 15): blocks of 512 threads when the call has at
    most one tile per SM (one tile's walk is then the path, so it takes
    the most warps), else 256 (several blocks per SM, whose loads and
    walks overlap each other's); one ring stage, or two when a block
    walks 2 to 4 tiles and the second stage costs no block per SM (it
    loads the next tile during the walk; over longer ranges it slowed the
    walks, a block walking one tile has nothing to prefetch, and where
    it cost a block per SM, olmo-1b's gate/up calls were slower).
    When every block walks one tile and an output tile's KT blocks (2 to
    ``MAX_CLUSTER``) can all be resident as clusters (``clusters(rows,
    threads, smem, size)`` says how many fit on the card), they add their
    partials in distributed shared memory instead of through memory and a
    counter."""
    tiles = groups * -(-m // row_tile(m)) * nt * kt
    threads = THREADS[1] if tiles <= sms else THREADS[0]
    args = (groups, m, kt, nt, bk, bn, budget, vbytes, xbytes, sms, per_sm,
            threads)
    one = plan_with(*args, 1)
    if one is None:
        raise RuntimeError(f"no block of {threads} threads fits on an SM "
                           f"(budget {budget})")
    two = plan_with(*args, 2)
    walked = -(-one.tiles // one.chunk // one.blocks) * one.chunk
    p = (two if two is not None and two.blocks >= one.blocks
         and 2 <= walked <= 4 else one)
    if (clusters is not None and p.chunk == 1 and p.blocks == p.tiles
            and 2 <= kt <= MAX_CLUSTER
            and clusters(p.rows, threads, p.smem, kt) * kt >= p.tiles):
        return dataclasses.replace(p, cluster=kt)
    return p


@functools.lru_cache(maxsize=None)
def _per_sm(x_bf16: int, v_bf16: int, rows: int, threads: int,
            smem: int) -> int:
    """Blocks of a variant of ``threads`` threads with ``smem`` bytes of
    shared memory that fit on an SM (the CUDA occupancy query)."""
    fn = _build.library().bitmap_spmm_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(x_bf16, v_bf16, rows, threads, smem)


@functools.lru_cache(maxsize=None)
def _clusters(x_bf16: int, v_bf16: int, rows: int, threads: int, smem: int,
              size: int) -> int:
    """Clusters of ``size`` such blocks that can be resident on the card
    at once (the CUDA occupancy query)."""
    fn = _build.library().bitmap_spmm_clusters
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn(x_bf16, v_bf16, rows, threads, smem, size)


@functools.lru_cache(maxsize=None)
def _plan(groups: int, m: int, kt: int, nt: int, bk: int, bn: int,
          budget: int, vbytes: int, xbytes: int, sms: int, x_bf16: int,
          v_bf16: int) -> StreamPlan:
    return stream_plan(groups, m, kt, nt, bk, bn, budget, vbytes, xbytes, sms,
                       lambda rows, threads, smem: _per_sm(
                           x_bf16, v_bf16, rows, threads, smem),
                       lambda rows, threads, smem, size: _clusters(
                           x_bf16, v_bf16, rows, threads, smem, size))


def x_bulk(x: torch.Tensor, bk: int) -> int:
    """1 when the rows of X's tile slices start on 16 bytes and are a
    multiple of 16 bytes long, so that the kernel copies them in bulk;
    else its threads load them."""
    row = x.element_size()
    return int(x.data_ptr() % 16 == 0 and (x.shape[-1] * row) % 16 == 0
               and (bk * row) % 16 == 0)


_COUNTERS: dict = {}


def counters(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` counters on ``device``.
    The kernel leaves every counter it uses at zero, so one buffer serves
    every launch on the device's stream; a larger one replaces it when a
    call needs more, and the old one is kept alive, since a captured CUDA
    graph may still point at it."""
    bufs = _COUNTERS.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1 << 16), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _launch(name: str, x: torch.Tensor, w: BitmapWeight, out: torch.Tensor,
            groups: int, kt: int, nt: int, bk: int, bn: int) -> None:
    """Plan and launch one K1 (``groups`` 0) or K1g call into ``out``."""
    m = x.shape[-2]
    xf, vf = _build.TYPE_FLAG[x.dtype], _build.TYPE_FLAG[w.values.dtype]
    plan = _plan(max(groups, 1), m, kt, nt, bk, bn, w.budget,
                 w.values.element_size(), x.element_size(),
                 _build.sm_count(x.device), xf, vf)
    partial = (torch.empty(plan.partial_floats, dtype=torch.float32,
                           device=x.device) if plan.partial_floats else None)
    cnt = counters(x.device, plan.outputs)
    lead = (groups,) if groups else ()
    rc = _entry(grouped=bool(groups))(
        x.data_ptr(), w.packed_bits.data_ptr(), w.values.data_ptr(),
        w.row_start.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None, cnt.data_ptr(),
        *lead, m, kt, nt, bk, bn, w.budget, plan.rows, plan.threads,
        plan.blocks, plan.cluster, plan.chunk, plan.stages, plan.stage_bytes, plan.off_bits,
        plan.off_rs, plan.off_x, plan.smem, x_bulk(x, bk), xf, vf,
        _build.TYPE_FLAG[out.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(name, rc)
    LAUNCHES[name] += 1


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
    _launch("bitmap_spmm", x, w, out, 0, kt, nt, bk, bn)
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
    _launch("bitmap_spmm_grouped", x, w, out, g, kt, nt, bk, bn)
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

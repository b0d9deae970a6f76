"""The paper's bitmap weight format, packed and unpacked with torch.

Port of ``repro/sparse/format.py``: per (BK, BN) tile a packed bitmap
(1 bit per element, little-endian within each byte), the tile's non-zero
values packed row by row into a per-tile budget of value slots, and one
start offset per row (the host-side half of EIM: the kernel finds a
value at ``row_start[row] + rank``).

Packing runs in torch on whatever device the weight lies on, with the
reference's algorithm: budget = the largest tile non-zero count,
``row_start`` = exclusive row cumsum, values at ``row_start + rank``.
The packed tensors are byte-equal to the reference's numpy pack.

The sharded layout (``shard_bitmap``) splits a packed weight's N (col)
or K (row) tile axis into S ranges behind an explicit shard axis, as
the reference does; a rank keeps one shard (``keep_part``) and
``gather_bitmap`` reassembles the whole weight over a process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class BitmapWeight:
    """Bitmap-compressed (K, N) weight, tiled (BK, BN).

    Stacked weights (``pack_bitmap_stacked``) carry a leading period axis
    on each tensor while ``shape`` stays per-matrix.  ``dense_cache`` is
    an optional pack-time dense rendering read only by the plain version
    (``kernels/ref.bitmap_spmm_ref``) on the CPU; the CUDA kernel never
    reads it, and it does not count toward ``hbm_bytes``.
    """

    packed_bits: torch.Tensor    # (KT, NT, BK, BN // 8) uint8
    values: torch.Tensor         # (KT, NT, budget), row-major packed
    row_start: torch.Tensor      # (KT, NT, BK) int32
    shape: Tuple[int, int]
    block: Tuple[int, int]
    dense_cache: Optional[torch.Tensor] = None   # (K, N)
    #: sharded layout: ``("col"|"row", S)`` when every tensor carries an
    #: explicit shard axis (extent S) just before its tile dims
    #: (``shard_bitmap``); ``shape`` and ``block`` stay the full logical
    #: geometry
    shard: Optional[Tuple[str, int]] = None
    #: one rank's share of a sharded weight: the tensors then hold only
    #: ``shard_slice(w, part)``'s (``keep_part``); ``gather_bitmap``
    #: reassembles the whole weight
    part: Optional[int] = None

    @property
    def budget(self) -> int:
        return self.values.shape[-1]

    @property
    def parts(self) -> int:
        """How many ranks' tensors make the whole weight: S for a rank's
        part of an S-way sharded weight, else 1."""
        return self.shard[1] if self.part is not None else 1

    @property
    def resident_bytes(self) -> int:
        """Bytes of packed tensors this object holds (a part: one
        rank's share)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.packed_bits, self.values, self.row_start))

    @property
    def hbm_bytes(self) -> int:
        """Bytes of the whole packed weight (every part of a sharded
        one), as the reference counts a sharded array."""
        return self.resident_bytes * self.parts

    @property
    def dense_bytes(self) -> int:
        stacks = (math.prod(self.values.shape[:-3])
                  if self.values.dim() > 3 else 1)
        if self.shard is not None and self.part is None:
            # the explicit shard axis inflates the leading dims, but the
            # S shards together hold exactly one logical matrix
            stacks //= self.shard[1]
        return (stacks * self.shape[0] * self.shape[1]
                * self.values.element_size())

    @property
    def compression(self) -> float:
        return self.dense_bytes / self.hbm_bytes

    @property
    def nnz(self) -> int:
        """Set bits in the bitmap: the non-zeros the product multiplies."""
        return int(_POPCOUNT.to(self.packed_bits.device)[
            self.packed_bits.long()].sum())

    def period(self, p: int) -> "BitmapWeight":
        """The p-th entry along the leading stack axis (views, no copy):
        a period of a period-stacked weight, the (E, ...)-leading
        weight of one period of an expert stack, or one expert of that
        (the reference's ``group_slice``)."""
        return BitmapWeight(
            packed_bits=self.packed_bits[p], values=self.values[p],
            row_start=self.row_start[p], shape=self.shape, block=self.block,
            dense_cache=(self.dense_cache[p]
                         if self.dense_cache is not None else None),
            shard=self.shard, part=self.part)


_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64)
_SHIFTS = torch.arange(8, dtype=torch.uint8)


def _pack_tiles(tiles: torch.Tensor, budget: int):
    """(KT, NT, BK, BN) tiles -> (packed_bits, values, row_start)."""
    kt, nt, bk, bn = tiles.shape
    bits = tiles != 0
    row_nnz = bits.sum(-1)
    row_start = torch.zeros((kt, nt, bk), dtype=torch.int64,
                            device=tiles.device)
    row_start[:, :, 1:] = torch.cumsum(row_nnz, -1)[:, :, :-1]
    slot = row_start[..., None] + torch.cumsum(bits, -1) - 1
    tile_base = (torch.arange(kt * nt, device=tiles.device)
                 * budget).view(kt, nt, 1, 1)
    values = torch.zeros(kt * nt * budget, dtype=tiles.dtype,
                         device=tiles.device)
    # boolean indexing walks the set bits in row-major order, the order
    # of np.nonzero in the reference
    values[(tile_base + slot)[bits]] = tiles[bits]
    shifts = _SHIFTS.to(tiles.device)
    packed = (bits.view(kt, nt, bk, bn // 8, 8).to(torch.uint8) << shifts
              ).sum(-1, dtype=torch.uint8)
    return packed, values.view(kt, nt, budget), row_start.to(torch.int32)


def _tiles(w: torch.Tensor, block: Tuple[int, int]) -> torch.Tensor:
    k, n = w.shape
    bk, bn = block
    assert k % bk == 0 and n % bn == 0, (tuple(w.shape), block)
    assert bn % 8 == 0, block
    return w.reshape(k // bk, bk, n // bn, bn).permute(0, 2, 1, 3)


def pack_bitmap(w: torch.Tensor, block: Tuple[int, int] = (128, 128),
                density_budget: float | None = None,
                budget: int | None = None,
                cache_dense: bool = False) -> BitmapWeight:
    """Pack a dense (K, N) tensor (zeros = pruned) into a BitmapWeight.

    Default budget = the largest tile non-zero count (lossless).  With
    ``density_budget`` a tile holding more than ``ceil(BK·BN·density)``
    non-zeros keeps its largest magnitudes; an explicit ``budget`` (at
    least the largest tile count) lets several packs share one budget.
    """
    k, n = w.shape
    bk, bn = block
    tiles = _tiles(w, block)
    per_tile = (tiles != 0).sum((-1, -2))
    if budget is not None:
        assert density_budget is None
        assert budget >= int(per_tile.max()), (budget, int(per_tile.max()))
    elif density_budget is None:
        budget = int(per_tile.max())
    else:
        budget = math.ceil(bk * bn * density_budget)
        if bool((per_tile > budget).any()):
            flat = tiles.abs().reshape(*per_tile.shape, -1)
            size = flat.shape[-1]
            # the reference's np.partition(flat, size - budget)[size - budget]
            kth = flat.kthvalue(size - budget + 1, dim=-1).values
            keep = (flat >= kth[..., None]) & (flat > 0)
            tiles = tiles * keep.view(tiles.shape)
    budget = max(budget, 1)
    packed, values, row_start = _pack_tiles(tiles.contiguous(), budget)
    dense = (tiles.permute(0, 2, 1, 3).reshape(k, n).clone()
             if cache_dense else None)
    return BitmapWeight(packed_bits=packed, values=values,
                        row_start=row_start, shape=(k, n), block=(bk, bn),
                        dense_cache=dense)


def unpack_bitmap(bw: BitmapWeight) -> torch.Tensor:
    """Plain decompression (the in-kernel EIM re-sort, whole matrix)."""
    kt, nt, bk, bnb = bw.packed_bits.shape
    bn = bnb * 8
    shifts = _SHIFTS.to(bw.packed_bits.device)
    bits = ((bw.packed_bits[..., None] >> shifts) & 1).reshape(kt, nt, bk, bn)
    rank = torch.cumsum(bits, -1, dtype=torch.int64) - 1
    idx = torch.clamp(bw.row_start[..., None].long() + rank, 0,
                      bw.budget - 1)
    vals = torch.gather(bw.values, -1, idx.reshape(kt, nt, bk * bn)
                        ).reshape(kt, nt, bk, bn)
    dense = torch.where(bits != 0, vals, torch.zeros((), dtype=vals.dtype,
                                                     device=vals.device))
    return dense.permute(0, 2, 1, 3).reshape(bw.shape)


# elements packed per pass over a stack: bounds the int64 temporaries of
# ``_pack_tiles`` (about 24 bytes per element) on a multi-GB expert stack
_PACK_CHUNK = 1 << 26


def pack_bitmap_stacked(w: torch.Tensor, block: Tuple[int, int],
                        cache_dense: bool = False) -> BitmapWeight:
    """Pack a period-stacked (P, K, N) tensor into one BitmapWeight whose
    tensors carry a leading P axis, all periods sharing one budget (the
    largest tile non-zero count across periods).  The matrices are
    packed several at a time, each exactly as ``pack_bitmap`` would."""
    assert w.dim() == 3, tuple(w.shape)
    p, k, n = w.shape
    bk, bn = block
    assert k % bk == 0 and n % bn == 0 and bn % 8 == 0, (tuple(w.shape),
                                                         block)
    kt, nt = k // bk, n // bn
    step = max(1, _PACK_CHUNK // (k * n))

    def tiles(lo: int) -> torch.Tensor:      # (c, KT, NT, BK, BN)
        return w[lo:lo + step].reshape(-1, kt, bk, nt, bn).permute(
            0, 1, 3, 2, 4)

    starts = range(0, p, step)
    budget = max(1, max(int((tiles(lo) != 0).sum((-1, -2)).max())
                        for lo in starts))
    parts = []
    for lo in starts:
        t = tiles(lo)
        packed = _pack_tiles(t.reshape(-1, nt, bk, bn), budget)
        parts.append([a.view(t.shape[0], kt, *a.shape[1:]) for a in packed])
    packed_bits, values, row_start = (torch.cat(a) for a in zip(*parts))
    return BitmapWeight(packed_bits=packed_bits, values=values,
                        row_start=row_start, shape=(k, n),
                        block=tuple(block),
                        dense_cache=(w.clone(memory_format=torch.contiguous_format)
                                     if cache_dense else None))


def unpack_bitmap_stacked(bw: BitmapWeight) -> torch.Tensor:
    """Dense rendering of a stacked BitmapWeight: recurses over every
    leading stack axis (one for period-stacked tensors, two for the
    (P, E) expert layout), returning ``(*stack_axes, K, N)``."""
    if bw.values.dim() == 3:
        return unpack_bitmap(bw)
    return torch.stack([unpack_bitmap_stacked(dataclasses.replace(
        bw.period(i), dense_cache=None))
        for i in range(bw.packed_bits.shape[0])])


def pack_bitmap_experts(w: torch.Tensor, block: Tuple[int, int],
                        cache_dense: bool = False) -> BitmapWeight:
    """Pack a period-stacked expert stack (P, E, K, N) into one
    BitmapWeight whose tensors carry leading (P, E) axes: the (P·E, K, N)
    stack packed as one, with one budget for all of it, then reshaped.
    ``period(p)`` is then the (E, ...)-leading weight that
    ``kernels/ops.bitmap_spmm_grouped`` takes."""
    assert w.dim() == 4, tuple(w.shape)
    p, e, k, n = w.shape
    flat = pack_bitmap_stacked(w.reshape(p * e, k, n), block=block,
                               cache_dense=cache_dense)
    return BitmapWeight(
        packed_bits=flat.packed_bits.view(p, e, *flat.packed_bits.shape[1:]),
        values=flat.values.view(p, e, *flat.values.shape[1:]),
        row_start=flat.row_start.view(p, e, *flat.row_start.shape[1:]),
        shape=(k, n), block=tuple(block),
        dense_cache=(flat.dense_cache.view(p, e, k, n)
                     if cache_dense else None))


def unpack_bitmap_experts(bw: BitmapWeight) -> torch.Tensor:
    """Dense (P, E, K, N) rendering of an expert-stacked BitmapWeight."""
    return unpack_bitmap_stacked(bw)


# --------------------------------------------------------------------------
# Sharded layout: the N (column-parallel) or K (row-parallel) tile axis is
# split into S contiguous shard ranges and re-exposed as an explicit shard
# axis just before each tensor's tile dims, so that each rank can keep one
# shard's bitmap, values and row starts.  ``shape`` / ``block`` keep the
# full logical geometry.  The tensors are the reference's, byte for byte.

#: trailing per-tile dims of each tensor (the shard axis sits just before
#: these; leading stack axes, period P and expert E, come first)
_TILE_ND = {"packed_bits": 4, "values": 3, "row_start": 3, "dense_cache": 2}


def _shard_off(mode: str, tile_nd: int) -> int:
    """Offset from ndim of the tile axis a mode splits: col splits the NT
    axis (the second tile dim, or N itself for ``dense_cache``), row
    splits KT (or K)."""
    return tile_nd - 1 if mode == "col" else tile_nd


def _split_leaf(leaf, tile_nd: int, mode: str, shards: int):
    """Split the sharded tile axis into ``shards`` contiguous ranges and
    move the new shard axis to just before the tile dims."""
    if leaf is None:
        return None
    nd = leaf.dim()
    ax = nd - _shard_off(mode, tile_nd)
    size = leaf.shape[ax]
    assert size % shards == 0, (tuple(leaf.shape), ax, shards)
    r = leaf.reshape(*leaf.shape[:ax], shards, size // shards,
                     *leaf.shape[ax + 1:])
    return r.movedim(ax, nd - tile_nd).contiguous()


def _merge_leaf(leaf, tile_nd: int, mode: str):
    """Inverse of ``_split_leaf``: fold the shard axis back into the tile
    axis it was split from (shard ranges are contiguous, so this is a
    reshape after the move)."""
    if leaf is None:
        return None
    n = leaf.dim()
    j = n - _shard_off(mode, tile_nd) - 1
    m = leaf.movedim(n - tile_nd - 1, j)
    return m.reshape(*m.shape[:j], m.shape[j] * m.shape[j + 1],
                     *m.shape[j + 2:])


def _leaves(bw: BitmapWeight):
    return {name: getattr(bw, name) for name in _TILE_ND}


def shard_bitmap(bw: BitmapWeight, shards: int, mode: str) -> BitmapWeight:
    """Re-lay a packed BitmapWeight out with an explicit shard axis.

    ``mode="col"`` splits the output-column tile axis (NT): each shard
    owns a contiguous N range (wq/wk/wv/w_gate/w_up, the vocabulary-split
    head); ``mode="row"`` splits the contraction tile axis (KT): each
    shard owns a K range and the partial products sum (wo/w_down).
    Lossless: each shard's tensors are exact slices of the unsharded
    pack."""
    assert mode in ("col", "row"), mode
    assert bw.shard is None, bw.shard
    if shards == 1:
        return bw
    return dataclasses.replace(
        bw, **{name: _split_leaf(leaf, _TILE_ND[name], mode, shards)
               for name, leaf in _leaves(bw).items()},
        shard=(mode, shards))


def unshard_bitmap(bw: BitmapWeight) -> BitmapWeight:
    """Fold the explicit shard axis back in: the exact unsharded pack."""
    if bw.shard is None:
        return bw
    assert bw.part is None, "a rank's part: gather_bitmap it"
    mode, _ = bw.shard
    return dataclasses.replace(
        bw, **{name: _merge_leaf(leaf, _TILE_ND[name], mode)
               for name, leaf in _leaves(bw).items()},
        shard=None)


def keep_part(bw: BitmapWeight, part: int) -> BitmapWeight:
    """One rank's share of a sharded weight: shard ``part``'s tensors,
    copied out contiguous, so that the whole weight can be freed."""
    assert bw.shard is not None and bw.part is None
    assert 0 <= part < bw.shard[1], (part, bw.shard)

    def take(leaf, tile_nd):
        if leaf is None:
            return None
        return leaf.select(leaf.dim() - tile_nd - 1, part).clone(
            memory_format=torch.contiguous_format)

    return dataclasses.replace(
        bw, **{name: take(leaf, _TILE_ND[name])
               for name, leaf in _leaves(bw).items()}, part=part)


def all_gather_concat(out: torch.Tensor, local: torch.Tensor,
                      group) -> None:
    """Every rank of ``group``'s ``local`` concatenated along dim 0 into
    ``out``, in rank order (``all_gather_into_tensor``).  The bytes
    travel as uint8, whatever the type; a gloo group gathers a card's
    tensors through host memory, as gloo does."""
    import torch.distributed as dist
    # flat first: a size-1 last dim may carry any stride, which a view
    # to bytes refuses
    src = local.contiguous().reshape(-1).view(torch.uint8)
    dst = out.view(-1).view(torch.uint8)
    if src.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(dst.shape, dtype=torch.uint8)
        dist.all_gather_into_tensor(host, src.cpu(), group=group)
        dst.copy_(host)
    else:
        dist.all_gather_into_tensor(dst, src, group=group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in place (and
    returned).  A gloo group reduces a card's tensor through host
    memory, as ``all_gather_concat`` gathers."""
    import torch.distributed as dist
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def gather_bitmap(bw: BitmapWeight, group) -> BitmapWeight:
    """All-gather every rank's part over ``group`` (the ranks holding
    parts 0 .. S-1, in that order) and fold the shard axis away: the
    whole unsharded BitmapWeight, byte-equal to ``unshard_bitmap`` of
    the sharded pack.  A weight that is not a part passes through."""
    if bw.part is None:
        return bw
    mode, shards = bw.shard

    def g(leaf, tile_nd):
        if leaf is None:
            return None
        out = torch.empty((shards * leaf.shape[0], *leaf.shape[1:]),
                          dtype=leaf.dtype, device=leaf.device)
        all_gather_concat(out, leaf.contiguous(), group)
        stacked = out.view(shards, *leaf.shape).movedim(
            0, leaf.dim() - tile_nd)
        return _merge_leaf(stacked, tile_nd, mode)

    return dataclasses.replace(
        bw, **{name: g(leaf, _TILE_ND[name])
               for name, leaf in _leaves(bw).items()},
        shard=None, part=None)


@dataclasses.dataclass
class BlockSparseWeight:
    """Block-sparse (K, N) weight: all-zero (BK, BN) blocks dropped.

    Per column block j, the surviving blocks in K order: ``values[j, s]``
    is K block ``kidx[j, s]`` for s < ``nnzb[j]``; the remaining slots up
    to ``smax`` are padding (zeros, K block 0)."""

    values: torch.Tensor     # (NT, SMAX, BK, BN)
    kidx: torch.Tensor       # (NT, SMAX) int32
    nnzb: torch.Tensor       # (NT,) int32
    shape: Tuple[int, int]
    block: Tuple[int, int]

    @property
    def smax(self) -> int:
        return self.values.shape[1]

    @property
    def hbm_bytes(self) -> int:
        return (self.values.numel() * self.values.element_size()
                + self.kidx.numel() * 4 + self.nnzb.numel() * 4)

    @property
    def density(self) -> float:
        """Surviving blocks over all blocks (reads ``nnzb``: a host
        synchronisation on the card)."""
        kt = self.shape[0] // self.block[0]
        return int(self.nnzb.sum()) / (kt * self.kidx.shape[0])


def pack_block_sparse(w: torch.Tensor, block: Tuple[int, int] = (128, 128)
                      ) -> BlockSparseWeight:
    """Pack a dense (K, N) tensor, dropping its all-zero (BK, BN) blocks;
    byte-equal to the reference's numpy pack, run on ``w``'s device."""
    k, n = w.shape
    bk, bn = block
    assert k % bk == 0 and n % bn == 0, (tuple(w.shape), block)
    kt, nt = k // bk, n // bn
    tiles = w.reshape(kt, bk, nt, bn).permute(2, 0, 1, 3)   # (NT, KT, BK, BN)
    alive = (tiles != 0).flatten(2).any(-1)                  # (NT, KT)
    nnzb = alive.sum(-1).to(torch.int32)
    smax = max(int(nnzb.max()), 1)
    values = torch.zeros((nt, smax, bk, bn), dtype=w.dtype, device=w.device)
    kidx = torch.zeros((nt, smax), dtype=torch.int32, device=w.device)
    # surviving (j, K block) pairs in row-major order; the slot of each is
    # its rank among its column block's survivors
    j, kb = alive.nonzero(as_tuple=True)
    slot = (torch.cumsum(alive, -1) - 1)[j, kb]
    values[j, slot] = tiles[j, kb]
    kidx[j, slot] = kb.to(torch.int32)
    return BlockSparseWeight(values=values, kidx=kidx, nnzb=nnzb,
                             shape=(k, n), block=(bk, bn))


def unpack_block_sparse(bw: BlockSparseWeight) -> torch.Tensor:
    """Dense (K, N) rendering: each valid slot added at its K block, as
    the reference's scatter-add."""
    nt, smax, bk, bn = bw.values.shape
    kt = bw.shape[0] // bk
    valid = (torch.arange(smax, device=bw.values.device)[None, :]
             < bw.nnzb[:, None])
    vals = torch.where(valid[..., None, None], bw.values,
                       torch.zeros((), dtype=bw.values.dtype,
                                   device=bw.values.device))
    dense = torch.zeros((nt, kt, bk, bn), dtype=bw.values.dtype,
                        device=bw.values.device)
    j = torch.arange(nt, device=bw.values.device).repeat_interleave(smax)
    dense.index_put_((j, bw.kidx.reshape(-1).long()),
                     vals.reshape(nt * smax, bk, bn), accumulate=True)
    return dense.permute(1, 2, 0, 3).reshape(bw.shape)

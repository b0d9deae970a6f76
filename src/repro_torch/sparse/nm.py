"""N:M structured sparsity along K, pruned and packed with torch.

Port of ``repro/sparse/nm.py``: every group of M consecutive K elements
of a column keeps N values, stored per (BK, BN) tile as the kept values
and their int8 offsets within the group, both (BK / M x N, BN), the
kept positions of a group in increasing order.  Everything runs on the
weight's device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class NmWeight:
    """(K, N) weight with N:M structure along K, tiled (BK, BN)."""

    values: torch.Tensor    # (KT, NT, BK // M * N, BN)
    idx: torch.Tensor       # (KT, NT, BK // M * N, BN) int8, offset in group
    shape: Tuple[int, int]
    block: Tuple[int, int]
    n_keep: int
    m_group: int

    @property
    def hbm_bytes(self) -> int:
        return (self.values.numel() * self.values.element_size()
                + self.idx.numel())

    @property
    def compression(self) -> float:
        dense = self.shape[0] * self.shape[1] * self.values.element_size()
        return dense / self.hbm_bytes


def _top_positions(groups: torch.Tensor, n: int) -> torch.Tensor:
    """(K/M, M, C) -> (K/M, n, C): positions of the n largest magnitudes
    of each group.  Equal magnitudes go to the lower position (a stable
    sort); the reference's ``np.argsort`` promises no order among them."""
    return torch.argsort(-groups.abs(), dim=1, stable=True)[:, :n, :]


def prune_nm(w: torch.Tensor, n: int = 1, m: int = 4) -> torch.Tensor:
    """Keep the top-``n`` magnitudes in every group of ``m`` along axis 0."""
    k, cols = w.shape
    assert k % m == 0, (k, m)
    groups = w.reshape(k // m, m, cols)
    keep = torch.zeros(groups.shape, dtype=torch.bool, device=w.device)
    keep.scatter_(1, _top_positions(groups, n), True)
    return (groups * keep).reshape(k, cols)


def pack_nm(w: torch.Tensor, n: int = 1, m: int = 4,
            block: Tuple[int, int] = (128, 128)) -> NmWeight:
    """Pack an N:M-structured (K, N) tensor (``prune_nm`` it first)."""
    k, cols = w.shape
    bk, bn = block
    assert k % bk == 0 and cols % bn == 0 and bk % m == 0, (
        tuple(w.shape), block, m)
    kt, nt = k // bk, cols // bn
    groups = w.reshape(k // m, m, cols)
    # the n largest magnitudes' positions, sorted by position
    top = _top_positions(groups, n).sort(dim=1).values       # (K/m, n, C)
    vals = torch.gather(groups, 1, top).reshape(k // m * n, cols)
    idx = top.reshape(k // m * n, cols).to(torch.int8)
    bkc = bk // m * n
    return NmWeight(
        values=vals.reshape(kt, bkc, nt, bn).permute(0, 2, 1, 3).contiguous(),
        idx=idx.reshape(kt, bkc, nt, bn).permute(0, 2, 1, 3).contiguous(),
        shape=(k, cols), block=tuple(block), n_keep=n, m_group=m)


def unpack_nm(nm: NmWeight) -> torch.Tensor:
    """Dense (K, N) rendering: each dense element the sum of its group's
    kept values whose offset names it (the reference's M x N selects)."""
    kt, nt, bkc, bn = nm.values.shape
    n, m = nm.n_keep, nm.m_group
    g = bkc // n                                   # groups per tile
    vals = nm.values.reshape(kt, nt, g, n, 1, bn)
    idx = nm.idx.reshape(kt, nt, g, n, 1, bn).long()
    pos = torch.arange(m, device=nm.idx.device).view(m, 1)
    dense = torch.where(idx == pos, vals, torch.zeros(
        (), dtype=vals.dtype, device=vals.device)).sum(3, dtype=vals.dtype)
    return dense.reshape(kt, nt, g * m, bn).permute(0, 2, 1, 3).reshape(
        nm.shape)

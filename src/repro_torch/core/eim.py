"""Effective Index Matching (EIM) — paper §II-C, Fig. 4.

EIM converts (input bitmap, weight bitmap) into per-PE streams of
*effective indexes* (EffI, EffW): positions of the two operands of every
non-zero multiplication inside the **compressed** buffers, emitted in
original-index order.  These streams feed the per-PE ``EIM_FIFO``s consumed
by the SIDR dataflow (``repro.core.sidr``).

Two implementations are provided and tested for equivalence:

* ``eim_reference`` — the intuitive masking method the paper describes first
  (mask BMNZ with BMI/BMW then re-sort) — direct but "not hardware efficient".
* ``eim_streams`` — the paper's two-step method using mask indexes
  (IMId/WMId) and masked bitmaps (IMBM/WMBM), fully vectorised; this is what
  the simulator and the Pallas decompression kernels mirror.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.bitmap import mask_index


@dataclasses.dataclass
class EimStreams:
    """Padded per-PE FIFO contents for a (M rows × N cols) tile.

    eff_i / eff_w : (M, N, L) int32 — compressed-buffer indexes per non-zero
        multiplication, in original-index order; padded with ``INVALID``.
    length        : (M, N) int32 — number of valid entries (= # non-zero MACs).
    """

    eff_i: np.ndarray
    eff_w: np.ndarray
    length: np.ndarray

    INVALID = np.int32(2**30)


def eim_reference(bmi: np.ndarray, bmw: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Naive single-PE EIM: returns (eff_i, eff_w) 1-D streams.

    bmi, bmw: (K,) bool bitmaps of one input row and one weight column.
    """
    bmi = np.asarray(bmi, bool)
    bmw = np.asarray(bmw, bool)
    bmnz = bmi & bmw
    pos = np.nonzero(bmnz)[0]
    rank_i = np.cumsum(bmi) - 1  # original idx -> compressed idx
    rank_w = np.cumsum(bmw) - 1
    return rank_i[pos].astype(np.int32), rank_w[pos].astype(np.int32)


def eim_two_step(bmi: np.ndarray, bmw: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The paper's hardware method for one PE.

    Step 1: mask indexes IMId/WMId (original index of each compressed slot) —
    shared by the whole row/column of PEs in hardware.
    Step 2: gather BMNZ at the mask indexes -> masked bitmaps IMBM/WMBM over
    compressed slots; the set positions *are* the effective indexes, and both
    masked bitmaps enumerate the same non-zero ops in the same (original
    index) order, so zipping them pairs the operands.
    """
    bmi = np.asarray(bmi, bool)
    bmw = np.asarray(bmw, bool)
    bmnz = bmi & bmw
    im_id = mask_index(bmi)          # (nnz_i,) original index per slot
    wm_id = mask_index(bmw)
    imbm = bmnz[im_id]               # which compressed input slots are used
    wmbm = bmnz[wm_id]
    eff_i = np.nonzero(imbm)[0].astype(np.int32)
    eff_w = np.nonzero(wmbm)[0].astype(np.int32)
    assert eff_i.shape == eff_w.shape
    return eff_i, eff_w


def eim_streams(bmi: np.ndarray, bmw: np.ndarray) -> EimStreams:
    """Vectorised EIM for a full tile.

    bmi: (M, K) bool — input bitmaps of the M rows (shared along PE rows).
    bmw: (N, K) bool — weight bitmaps of the N columns (shared along cols).

    Leading batch dimensions are supported: bmi (..., M, K), bmw (..., N, K)
    with identical leading shape.
    """
    bmi = np.asarray(bmi, bool)
    bmw = np.asarray(bmw, bool)
    *lead, m, k = bmi.shape
    n = bmw.shape[-2]

    bmnz = bmi[..., :, None, :] & bmw[..., None, :, :]       # (..., M, N, K)
    length = bmnz.sum(-1).astype(np.int32)                    # (..., M, N)
    lmax = max(int(length.max()) if length.size else 0, 1)

    order = np.cumsum(bmnz, axis=-1, dtype=np.int32) - 1      # rank of each op
    rank_i = (np.cumsum(bmi, -1, dtype=np.int32) - 1)[..., :, None, :]
    rank_w = (np.cumsum(bmw, -1, dtype=np.int32) - 1)[..., None, :, :]

    shape = tuple(lead) + (m, n, lmax)
    eff_i = np.full(shape, EimStreams.INVALID, np.int32)
    eff_w = np.full(shape, EimStreams.INVALID, np.int32)
    idx = np.nonzero(bmnz)
    slot = idx[:-1] + (order[idx],)
    eff_i[slot] = np.broadcast_to(rank_i, bmnz.shape)[idx]
    eff_w[slot] = np.broadcast_to(rank_w, bmnz.shape)[idx]
    return EimStreams(eff_i=eff_i, eff_w=eff_w, length=length)

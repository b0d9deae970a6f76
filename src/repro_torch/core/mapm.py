"""MAPM (Memory Access per MAC) analytics — paper §I and §III-A.

MAPM = bytes of on-chip SRAM buffer traffic per executed MAC (byte/MAC) with
8-bit operands and 1-byte output write-back, matching the paper's dense 4×4
example: (16 inputs + 16 weights + 16 outputs) / 64 MACs = 0.75 B/MAC.

Baseline dataflow models (the designs the paper compares against):

* ``dense_output_stationary`` — classic dense DLA (Eyeriss/VWA style):
  every input/weight read once per tile, outputs written once.
* ``sparten``   — dot-product dataflow, reuses only outputs: both operands of
  every MAC are fetched from SRAM (2 B/MAC) + output write-back + a matching
  overhead for re-fetch on failed prefix-sum matches.  The paper measured
  2.09 B/MAC for SparTen; our first-principles model gives ≈2.0 and we keep
  the paper's measured value as the comparison reference.
* ``scnn``      — Cartesian-product dataflow, reuses only inputs: operands are
  amortised but every MAC's partial sum is written to and read back from the
  psum SRAM (2 B/MAC).  Paper measured 2.03 B/MAC.
* ``ours``      — measured by the SIDR cycle simulator (``repro.core.sidr``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataflowCounts:
    macs: int
    sram_bytes: float

    @property
    def mapm(self) -> float:
        return self.sram_bytes / max(self.macs, 1)


def _tile_counts(m: int, n: int, k: int, tile: int = 16):
    tiles_m = -(-m // tile)
    tiles_n = -(-n // tile)
    return tiles_m, tiles_n


def dense_output_stationary(m: int, n: int, k: int, tile: int = 16
                            ) -> DataflowCounts:
    """Dense DLA with full broadcast reuse on a tile×tile array.

    Per (tile_m, tile_n) output tile: read tile·K inputs + tile·K weights,
    write tile² outputs. MACs = m·n·k (zeros are not skipped).
    """
    tm, tn = _tile_counts(m, n, k, tile)
    reads = tm * tn * (tile * k + tile * k)
    writes = tm * tn * tile * tile
    return DataflowCounts(macs=m * n * k, sram_bytes=reads + writes)


def sparten(nnz_macs: int, num_outputs: int,
            match_refetch: float = 0.0) -> DataflowCounts:
    """SparTen-style dot-product dataflow (output reuse only)."""
    bytes_ = (2.0 + 2.0 * match_refetch) * nnz_macs + num_outputs
    return DataflowCounts(macs=nnz_macs, sram_bytes=bytes_)


SPARTEN_PAPER_MAPM = 2.09  # measured value reported in the paper
SCNN_PAPER_MAPM = 2.03


def scnn(nnz_macs: int, nnz_inputs: int, nnz_weights: int) -> DataflowCounts:
    """SCNN-style Cartesian-product dataflow (input reuse only).

    Inputs/weights are each fetched once; every MAC's partial sum is written
    to and read back from the psum buffer (scatter-accumulate).
    """
    bytes_ = nnz_inputs + nnz_weights + 2.0 * nnz_macs
    return DataflowCounts(macs=nnz_macs, sram_bytes=bytes_)


def sparse_macs(x: np.ndarray, w: np.ndarray) -> int:
    """Number of non-zero MACs of X (M,K) @ W(N,K)^T."""
    bx = (np.asarray(x) != 0).astype(np.int64)
    bw = (np.asarray(w) != 0).astype(np.int64)
    return int((bx @ bw.T).sum())


def reduction_vs_sparten(our_mapm: float,
                         sparten_mapm: float = SPARTEN_PAPER_MAPM) -> float:
    """Fractional SRAM-access reduction (paper headline: 86 % vs SparTen)."""
    return 1.0 - our_mapm / sparten_mapm

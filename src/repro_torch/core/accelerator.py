"""Whole-accelerator model: tiled sparse GEMM on the 16×16 SIDR array.

Maps an (M,K)×(K,N) GEMM onto the PE array: 16-row × 16-column output tiles,
K split into SRAM-buffer-sized chunks, output-stationary across K chunks
(accumulators persist in the PEs, so outputs hit SRAM once).  Per-tile
behaviour comes from the cycle-accurate SIDR simulator; this module
aggregates cycles / SRAM traffic / energy and derives the paper's metrics
(MAPM, utilisation, speed-up vs dense, TOPS/W).

Large GEMMs are statistically homogeneous across row tiles, so the simulator
can subsample row tiles (``max_row_tiles``) and scale the counts — used by
the benchmarks to keep single-core runtime sane; exact mode is the default.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import energy as energy_model
from repro_torch.core.mapm import (DataflowCounts, scnn, sparten, sparse_macs,
                             SPARTEN_PAPER_MAPM)
from repro_torch.core.bitmap import compress_rows
from repro_torch.core.sidr import SidrStats, simulate


@dataclasses.dataclass
class AcceleratorConfig:
    array_m: int = 16
    array_n: int = 16
    reg_size: int = 8
    k_buffer: int = 4096       # K elements resident per pass (SRAM capacity)
    tile_batch: int = 64       # tiles simulated per vectorised batch


@dataclasses.dataclass
class GemmReport:
    m: int
    n: int
    k: int
    stats: SidrStats
    dense_cycles: int
    sparten_counts: DataflowCounts
    scnn_counts: DataflowCounts
    sampled_fraction: float = 1.0
    outputs: np.ndarray | None = None

    @property
    def mapm(self) -> float:
        return self.stats.mapm

    @property
    def utilization(self) -> float:
        return self.stats.utilization

    @property
    def speedup_vs_dense(self) -> float:
        return self.dense_cycles / max(self.stats.cycles, 1)

    @property
    def sram_reduction_vs_sparten(self) -> float:
        return 1.0 - self.mapm / SPARTEN_PAPER_MAPM

    @property
    def energy(self) -> energy_model.EnergyReport:
        return energy_model.energy_from_stats(self.stats)

    @property
    def tops_per_watt(self) -> float:
        return energy_model.tops_per_watt(self.stats.macs, self.energy.total_j)

    def summary(self) -> dict:
        return {
            "shape": (self.m, self.n, self.k),
            "macs": self.stats.macs,
            "cycles": self.stats.cycles,
            "mapm": round(self.mapm, 4),
            "utilization": round(self.utilization, 4),
            "speedup_vs_dense": round(self.speedup_vs_dense, 3),
            "sram_reduction_vs_sparten": round(
                self.sram_reduction_vs_sparten, 4),
            "sparten_mapm": round(self.sparten_counts.mapm, 4),
            "scnn_mapm": round(self.scnn_counts.mapm, 4),
            "tops_per_watt": round(self.tops_per_watt, 4),
            "deadlock_breaks": self.stats.deadlock_breaks,
        }


def _pad_rows(x: np.ndarray, tile: int) -> np.ndarray:
    m = x.shape[0]
    pad = (-m) % tile
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x


def run_gemm(x: np.ndarray, w: np.ndarray,
             cfg: AcceleratorConfig | None = None,
             compute_values: bool = False,
             max_row_tiles: int | None = None,
             seed: int = 0) -> GemmReport:
    """Execute O = X @ W^T on the modelled accelerator.

    x: (M, K) activations, w: (N, K) weights (possibly pruned to zeros).
    """
    cfg = cfg or AcceleratorConfig()
    x = np.asarray(x)
    w = np.asarray(w)
    m, k = x.shape
    n = w.shape[0]
    assert w.shape[1] == k

    xp = _pad_rows(x, cfg.array_m)
    wp = _pad_rows(w, cfg.array_n)
    tm = xp.shape[0] // cfg.array_m
    tn = wp.shape[0] // cfg.array_n

    rng = np.random.default_rng(seed)
    row_tiles = np.arange(tm)
    sampled_fraction = 1.0
    if max_row_tiles is not None and tm > max_row_tiles:
        row_tiles = np.sort(rng.choice(tm, size=max_row_tiles, replace=False))
        sampled_fraction = max_row_tiles / tm

    x_tiles = xp.reshape(tm, cfg.array_m, k)[row_tiles]
    w_tiles = wp.reshape(tn, cfg.array_n, k)

    n_chunks = -(-k // cfg.k_buffer)
    total: SidrStats | None = None
    outputs = (np.zeros((len(row_tiles) * cfg.array_m, wp.shape[0]))
               if compute_values else None)

    pairs = [(i, j) for i in range(len(row_tiles)) for j in range(tn)]
    for c in range(n_chunks):
        k0, k1 = c * cfg.k_buffer, min((c + 1) * cfg.k_buffer, k)
        bx, vx, nx = compress_rows(
            x_tiles[:, :, k0:k1].reshape(-1, k1 - k0))
        bw, vw, nw = compress_rows(
            w_tiles[:, :, k0:k1].reshape(-1, k1 - k0))
        bx = bx.reshape(len(row_tiles), cfg.array_m, -1)
        vx = vx.reshape(len(row_tiles), cfg.array_m, -1)
        nx = nx.reshape(len(row_tiles), cfg.array_m)
        bw = bw.reshape(tn, cfg.array_n, -1)
        vw = vw.reshape(tn, cfg.array_n, -1)
        nw = nw.reshape(tn, cfg.array_n)

        for b0 in range(0, len(pairs), cfg.tile_batch):
            batch = pairs[b0:b0 + cfg.tile_batch]
            bi = np.array([p[0] for p in batch])
            bj = np.array([p[1] for p in batch])
            stats = simulate(
                bx[bi], bw[bj], vx[bi] if compute_values else None,
                vw[bj] if compute_values else None,
                nnz_i=nx[bi], nnz_w=nw[bj],
                reg_size=cfg.reg_size, compute_values=compute_values)
            if compute_values:
                for t_idx, (ti, tj) in enumerate(batch):
                    r0 = ti * cfg.array_m
                    c0 = tj * cfg.array_n
                    outputs[r0:r0 + cfg.array_m,
                            c0:c0 + cfg.array_n] += stats.outputs[t_idx]
            stats.outputs = None
            total = stats if total is None else total.merge(stats)

    # outputs hit SRAM once per (row,col) tile pair, not once per K chunk
    total.output_bytes = len(row_tiles) * cfg.array_m * tn * cfg.array_n
    dense_cycles = len(row_tiles) * tn * k

    if sampled_fraction < 1.0:
        scale = 1.0 / sampled_fraction
        total = SidrStats(
            macs=int(total.macs * scale),
            cycles=int(total.cycles * scale),
            max_cycles=total.max_cycles,
            input_bytes=int(total.input_bytes * scale),
            weight_bytes=int(total.weight_bytes * scale),
            output_bytes=int(total.output_bytes * scale),
            bitmap_bytes=int(total.bitmap_bytes * scale),
            register_bytes=int(total.register_bytes * scale),
            idle_pe_cycles=int(total.idle_pe_cycles * scale),
            deadlock_breaks=total.deadlock_breaks,
            num_pes=total.num_pes,
        )
        dense_cycles = int(dense_cycles / sampled_fraction)

    bx_full = x != 0
    bw_full = w != 0
    nnz_macs = total.macs
    sparten_counts = sparten(nnz_macs, m * n)
    scnn_counts = scnn(nnz_macs, int(bx_full.sum()) * 1, int(bw_full.sum()))

    if compute_values:
        full = np.zeros((xp.shape[0], wp.shape[0]))
        for t_idx, ti in enumerate(row_tiles):
            full[ti * cfg.array_m:(ti + 1) * cfg.array_m] = outputs[
                t_idx * cfg.array_m:(t_idx + 1) * cfg.array_m]
        outputs = full[:m, :n]

    return GemmReport(m=m, n=n, k=k, stats=total, dense_cycles=dense_cycles,
                      sparten_counts=sparten_counts, scnn_counts=scnn_counts,
                      sampled_fraction=sampled_fraction, outputs=outputs)

"""Shared Index Data Reuse (SIDR) — cycle-level simulator of Algorithm 1.

Simulates the 16×16 output-stationary PE array with 8-entry shared registers
per row (inputs) and per column (weights).  Fully vectorised over a leading
batch of tiles, so whole GEMMs are simulated as one numpy program.

Faithful semantics (paper Algorithm 1):
  * per-PE EIM FIFOs hold (EffI, EffW) streams (from ``repro.core.eim``);
  * a PE pops a new pair only if it was not IDLE in the previous iteration;
  * SharedI_m = min over the row's *active* PEs of EffI (lagging PEs first),
    SharedW_n likewise per column;
  * shared registers buffer ``Buf[Shared : Shared+R]``; a PE fires iff both
    offsets are < R, else it idles this cycle;
  * output-stationary accumulation; outputs written back once per tile.

SRAM accounting (the paper's MAPM numerator):
  * the shared-register window slides monotonically, so each *newly covered*
    compressed element is fetched from SRAM exactly once (elements skipped by
    a window jump are never fetched);
  * output write-back: 1 byte per output (matches the paper's dense 4×4
    example accounting: 32 reads + 16 writes / 64 MACs = 0.75 B/MAC);
  * bitmap reads for EIM are tracked separately (``bitmap_bytes``).

The simulator also *computes the actual products* so correctness of the whole
EIM+SIDR pipeline is checked against a dense matmul in the tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.eim import EimStreams, eim_streams


@dataclasses.dataclass
class SidrStats:
    """Aggregate statistics of one simulate() call (batch of tiles)."""

    macs: int                 # non-zero MACs executed
    cycles: int               # sum over tiles of per-tile cycles
    max_cycles: int           # slowest tile (array executes tiles serially)
    input_bytes: int          # SRAM reads of compressed input values
    weight_bytes: int         # SRAM reads of compressed weight values
    output_bytes: int         # SRAM writes of outputs
    bitmap_bytes: int         # SRAM reads of bitmaps for EIM (reported aside)
    register_bytes: int       # shared-register fetches (2 per MAC)
    idle_pe_cycles: int       # PE-cycles spent idling (offset >= R)
    deadlock_breaks: int      # direct-fetch fallbacks (should be ~0)
    num_pes: int              # PEs in the array (M*N)
    outputs: np.ndarray | None = None  # (..., M, N) accumulators

    @property
    def sram_bytes(self) -> int:
        return self.input_bytes + self.weight_bytes + self.output_bytes

    @property
    def mapm(self) -> float:
        """Memory Access per MAC, bytes/MAC (paper's indicator)."""
        return self.sram_bytes / max(self.macs, 1)

    @property
    def utilization(self) -> float:
        return self.macs / max(self.cycles * self.num_pes, 1)

    def merge(self, other: "SidrStats") -> "SidrStats":
        assert self.num_pes == other.num_pes
        return SidrStats(
            macs=self.macs + other.macs,
            cycles=self.cycles + other.cycles,
            max_cycles=max(self.max_cycles, other.max_cycles),
            input_bytes=self.input_bytes + other.input_bytes,
            weight_bytes=self.weight_bytes + other.weight_bytes,
            output_bytes=self.output_bytes + other.output_bytes,
            bitmap_bytes=self.bitmap_bytes + other.bitmap_bytes,
            register_bytes=self.register_bytes + other.register_bytes,
            idle_pe_cycles=self.idle_pe_cycles + other.idle_pe_cycles,
            deadlock_breaks=self.deadlock_breaks + other.deadlock_breaks,
            num_pes=self.num_pes,
            outputs=None,
        )


def simulate(bmi: np.ndarray, bmw: np.ndarray,
             vi: np.ndarray | None = None, vw: np.ndarray | None = None,
             nnz_i: np.ndarray | None = None, nnz_w: np.ndarray | None = None,
             reg_size: int = 8, compute_values: bool = False) -> SidrStats:
    """Simulate SIDR for a batch of tiles.

    bmi: (..., M, K) bool input bitmaps;  bmw: (..., N, K) bool weight bitmaps.
    vi:  (..., M, P) packed compressed input values (P >= max nnz), optional;
    vw:  (..., N, Q) packed compressed weight values.
    Every (m, n) PE computes the sparse dot product of row m and column n.
    """
    bmi = np.asarray(bmi, bool)
    bmw = np.asarray(bmw, bool)
    if (vi is None) != (vw is None):
        raise ValueError(
            "simulate() needs vi and vw together (got "
            f"vi={'set' if vi is not None else None}, "
            f"vw={'set' if vw is not None else None}); pass both packed "
            "value arrays or neither")
    streams: EimStreams = eim_streams(bmi, bmw)
    *lead, m, n, lmax = streams.eff_i.shape
    lead = tuple(lead)
    unbatched = not lead
    if unbatched:
        lead = (1,)
        streams = EimStreams(streams.eff_i[None], streams.eff_w[None],
                             streams.length[None])
        bmi, bmw = bmi[None], bmw[None]
        if vi is not None:
            vi, vw = vi[None], vw[None]
    t = int(np.prod(lead))
    eff_i = streams.eff_i.reshape(t, m, n, lmax)
    eff_w = streams.eff_w.reshape(t, m, n, lmax)
    length = streams.length.reshape(t, m, n)
    if nnz_i is None:
        nnz_i = bmi.sum(-1)
    if nnz_w is None:
        nnz_w = bmw.sum(-1)
    nnz_i = np.asarray(nnz_i).reshape(t, m).astype(np.int64)
    nnz_w = np.asarray(nnz_w).reshape(t, n).astype(np.int64)

    compute_values = compute_values and vi is not None
    if compute_values:
        vi = np.asarray(vi).reshape(t, m, -1)
        vw = np.asarray(vw).reshape(t, n, -1)
        acc = np.zeros((t, m, n), np.float64)
    else:
        acc = None

    INF = np.int64(EimStreams.INVALID)
    ptr = np.zeros((t, m, n), np.int64)
    done = ptr >= length                      # PEs with empty FIFOs are done
    tile_alive = ~done.reshape(t, -1).all(-1)

    cycles = np.zeros(t, np.int64)
    idle_pe_cycles = 0
    deadlock_breaks = 0
    input_hi = np.zeros((t, m), np.int64)     # high-water mark of fetched elems
    weight_hi = np.zeros((t, n), np.int64)
    input_bytes = np.zeros(t, np.int64)
    weight_bytes = np.zeros(t, np.int64)
    register_bytes = 0

    ar_t = np.arange(t)[:, None, None]
    ar_m = np.arange(m)[None, :, None]
    ar_n = np.arange(n)[None, None, :]

    guard = 0
    max_guard = int(lmax) * m * n + 16
    while tile_alive.any():
        guard += 1
        if guard > max_guard:  # pragma: no cover - safety net
            raise RuntimeError("SIDR simulator failed to converge")
        active = ~done
        # -- pop/peek current effective pair (idle PEs retry the same pair)
        cur_p = np.minimum(ptr, length - 1)
        ei = np.where(active, eff_i[ar_t, ar_m, ar_n, cur_p], INF)
        ew = np.where(active, eff_w[ar_t, ar_m, ar_n, cur_p], INF)
        # -- shared indexes: min over the row / column's active PEs
        shared_i = ei.min(axis=2)             # (t, m)
        shared_w = ew.min(axis=1)             # (t, n)
        off_i = ei - shared_i[:, :, None]
        off_w = ew - shared_w[:, None, :]
        fire = active & (off_i < reg_size) & (off_w < reg_size)

        # -- deadlock break: no PE of an alive tile can fire -> let the PE
        # with the smallest combined offset fetch directly from SRAM.
        fired_any = fire.reshape(t, -1).any(-1)
        stuck = tile_alive & ~fired_any
        if stuck.any():
            comb = np.where(active, off_i + off_w, INF)
            flat = comb.reshape(t, -1)
            pick = flat.argmin(-1)
            s_idx = np.nonzero(stuck)[0]
            fire[s_idx, pick[s_idx] // n, pick[s_idx] % n] = True
            deadlock_breaks += int(stuck.sum())
            input_bytes[s_idx] += 1
            weight_bytes[s_idx] += 1

        # -- SRAM fetch accounting: newly covered window elements
        row_active = active.any(2)
        hi_new = np.minimum(shared_i + reg_size, nnz_i)
        lo_new = np.maximum(input_hi, np.minimum(shared_i, nnz_i))
        loads = np.where(row_active, np.maximum(hi_new - lo_new, 0), 0)
        input_bytes += loads.sum(1)
        input_hi = np.maximum(input_hi, np.where(row_active, hi_new, 0))

        col_active = active.any(1)
        hi_new_w = np.minimum(shared_w + reg_size, nnz_w)
        lo_new_w = np.maximum(weight_hi, np.minimum(shared_w, nnz_w))
        loads_w = np.where(col_active, np.maximum(hi_new_w - lo_new_w, 0), 0)
        weight_bytes += loads_w.sum(1)
        weight_hi = np.maximum(weight_hi, np.where(col_active, hi_new_w, 0))

        # -- execute MACs
        if compute_values:
            f_t, f_m, f_n = np.nonzero(fire)
            prod = (vi[f_t, f_m, ei[f_t, f_m, f_n]].astype(np.float64)
                    * vw[f_t, f_n, ew[f_t, f_m, f_n]])
            np.add.at(acc, (f_t, f_m, f_n), prod)
        register_bytes += 2 * int(fire.sum())
        idle_pe_cycles += int((active & ~fire).sum())

        ptr = ptr + fire
        done = ptr >= length
        cycles += tile_alive
        tile_alive = ~done.reshape(t, -1).all(-1)

    macs = int(length.sum())
    outputs = acc.reshape(*lead, m, n) if compute_values else None
    if compute_values and unbatched:
        outputs = outputs[0]
    return SidrStats(
        macs=macs,
        cycles=int(cycles.sum()),
        max_cycles=int(cycles.max()) if t else 0,
        input_bytes=int(input_bytes.sum()),
        weight_bytes=int(weight_bytes.sum()),
        output_bytes=t * m * n,
        bitmap_bytes=t * (m + n) * ((bmi.shape[-1] + 7) // 8),
        register_bytes=register_bytes,
        idle_pe_cycles=idle_pe_cycles,
        deadlock_breaks=deadlock_breaks,
        num_pes=m * n,
        outputs=outputs,
    )

"""28 nm event-level energy model — reproduces paper Table I / Figs. 8-9.

Per-event energies follow Horowitz (ISSCC'14, 45 nm) scaled to 28 nm
(~0.55× dynamic energy), the technology the paper synthesises in:

    8-bit multiply          0.12 pJ  (45nm: 0.2 pJ)
    24-bit accumulate add   0.06 pJ
    SRAM read/write         ~0.7 pJ/byte (8-16 KB macro)
    register/MUX fetch      0.03 pJ/byte
    EIM matching logic      0.05 pJ per matched pair (bitmap AND + re-sort
                            amortised over the row/col share)

The model's purpose is *relative* dataflow comparison (ours vs SparTen-style
vs SCNN-style): energy ratios are dominated by the SRAM-traffic term the
paper optimises.  A fixed overhead share (clock tree, FIFOs, control) is
calibrated so the dense-utilisation operating point reproduces the paper's
2.066 TOPS/W; the *sparse* operating point (66 % utilisation) then follows
from counted events — reproducing ≈1.2 TOPS/W is a model validation, not an
input.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sidr import SidrStats

PJ = 1e-12

E_MULT8 = 0.12 * PJ
E_ADD24 = 0.06 * PJ
E_MAC = E_MULT8 + E_ADD24
E_SRAM_BYTE = 0.70 * PJ
E_REG_BYTE = 0.03 * PJ
E_EIM_PAIR = 0.05 * PJ
# static/control energy per PE-cycle (clock tree, FIFO regs, idle PEs) —
# calibrated once against Table I's dense operating point (2.066 TOPS/W).
E_CYCLE_PE = 0.045 * PJ

CLOCK_HZ = 800e6
NUM_MACS = 256  # 16x16 array


@dataclasses.dataclass
class EnergyReport:
    mac_j: float
    sram_j: float
    register_j: float
    eim_j: float
    control_j: float

    @property
    def total_j(self) -> float:
        return (self.mac_j + self.sram_j + self.register_j + self.eim_j
                + self.control_j)

    def breakdown(self) -> dict:
        t = self.total_j
        return {
            "MAC": self.mac_j / t,
            "SRAM buffer": self.sram_j / t,
            "Shared registers": self.register_j / t,
            "EIM": self.eim_j / t,
            "Control/clock": self.control_j / t,
        }


def energy_from_stats(stats: SidrStats) -> EnergyReport:
    """Energy of one simulated workload under the event model."""
    return EnergyReport(
        mac_j=stats.macs * E_MAC,
        sram_j=(stats.sram_bytes + stats.bitmap_bytes) * E_SRAM_BYTE,
        register_j=stats.register_bytes * E_REG_BYTE,
        eim_j=stats.macs * E_EIM_PAIR,
        control_j=stats.cycles * stats.num_pes * E_CYCLE_PE,
    )


def energy_dataflow(macs: int, sram_bytes: float, cycles: float,
                    num_pes: int = NUM_MACS) -> float:
    """Energy (J) of a generic dataflow given its event counts.

    Used for SparTen/SCNN-style comparisons where we have analytic byte
    counts instead of a cycle simulation; register traffic is folded into the
    2 B/MAC operand fetches those dataflows already pay.
    """
    return (macs * (E_MAC + E_EIM_PAIR) + sram_bytes * E_SRAM_BYTE
            + cycles * num_pes * E_CYCLE_PE)


def tops_per_watt(macs: int, energy_j: float) -> float:
    """TOPS/W counting only non-zero ops (SIGMA's rigorous accounting);
    1 MAC = 2 ops."""
    return (2.0 * macs / energy_j) / 1e12


def power_watts(energy_j: float, cycles: int) -> float:
    return energy_j / (cycles / CLOCK_HZ)

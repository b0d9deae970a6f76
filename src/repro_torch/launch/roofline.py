"""Roofline terms of one NVIDIA H100 SXM.

The port's counterpart of ``repro/launch/hlo_analysis.roofline``, with
the card's published peaks (NVIDIA's H100 SXM data sheet, dense rates,
at the full 700 W power limit) in place of the reference's TPU
constants.  ``chip_smoke.py`` takes its bounds from the same two
numbers.  The reference's ``collective_bytes`` parses XLA's HLO text and
has no counterpart here: the port compiles no HLO.
"""
from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12        # HBM3
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
NVLINK_BYTES_PER_S = 450e9       # NVLink 4, one direction (900 GB/s both)


def roofline(flops: float, hbm_bytes: float,
             wire_bytes: float = 0.0) -> Dict[str, float]:
    """The three per-device time terms (seconds) and the bottleneck,
    under the reference's keys.  ``wire_bytes`` are the bytes a device
    sends to its peers over NVLink; one card sends none, so its
    collective term is 0."""
    terms = {"compute_s": flops / BF16_FLOPS_PER_S,
             "memory_s": hbm_bytes / HBM_BYTES_PER_S,
             "collective_s": wire_bytes / NVLINK_BYTES_PER_S}
    bound = max(terms, key=terms.get)
    t_max = terms[bound]
    t_sum = sum(terms.values())
    return {
        **terms,
        "bottleneck": bound.replace("_s", ""),
        # share of the ideal overlapped step this term would allow
        "roofline_fraction_overlap": t_max / t_sum if t_sum else 0.0,
        "step_time_overlapped_s": t_max,
    }

"""Faithful reproduction of the paper's accelerator: EIM + SIDR + MAPM.

Layers:
  bitmap      — bitmap sparse format (Fig. 1) + global-L1 pruning
  eim         — Effective Index Matching (§II-C, Fig. 4)
  sidr        — cycle-level SIDR simulator of Algorithm 1 (16×16 PE array)
  mapm        — Memory-Access-per-MAC analytics + SparTen/SCNN/dense baselines
  energy      — 28 nm event-level energy model (Table I, Figs. 8-9)
  accelerator — tiled GEMM → PE array aggregation (speed-up, TOPS/W)
  mobilenet   — MobileNetV2 PW-layer workload inventory (§III-A)
"""
from repro_torch.core.accelerator import AcceleratorConfig, GemmReport, run_gemm
from repro_torch.core.bitmap import (BitmapVector, compress, compress_rows,
                               mask_index, prune_global_l1, random_sparse)
from repro_torch.core.eim import EimStreams, eim_reference, eim_streams, eim_two_step
from repro_torch.core.mapm import (dense_output_stationary, reduction_vs_sparten,
                             scnn, sparse_macs, sparten)
from repro_torch.core.sidr import SidrStats, simulate

__all__ = [
    "AcceleratorConfig", "GemmReport", "run_gemm", "BitmapVector", "compress",
    "compress_rows", "mask_index", "prune_global_l1", "random_sparse",
    "EimStreams", "eim_reference", "eim_streams", "eim_two_step",
    "dense_output_stationary", "reduction_vs_sparten", "scnn", "sparse_macs",
    "sparten", "SidrStats", "simulate",
]

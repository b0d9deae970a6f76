"""Design-space study of the paper's accelerator (beyond-paper ablations),
with the port's accelerator model (``repro_torch.core``, numpy only).

Sweeps the two structural knobs the paper fixes — shared-register size
(8) and PE-array shape (16×16) — over the MobileNetV2-like operating point
and reports MAPM / utilisation / TOPS/W for each, answering "did the paper
pick a good design point?" (Spoiler: reg=8 sits at the knee.)

Run:  PYTHONPATH=src python examples/torch/accelerator_study.py
"""
import argparse

import numpy as np

from repro_torch.core.accelerator import AcceleratorConfig, run_gemm
from repro_torch.core.bitmap import prune_global_l1, random_sparse
from repro_torch.core.energy import energy_from_stats, tops_per_watt

REGS = (2, 4, 8, 16, 32)
ARRAYS = ((8, 8), (16, 16), (32, 32), (8, 32))


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]
                            ).parse_args(argv)
    rng = np.random.default_rng(0)
    x = random_sparse((256, 512), 0.45, rng)
    w = prune_global_l1(rng.standard_normal((256, 512)).astype(np.float32),
                        0.75)

    print("shared-register size sweep (PE array fixed 16x16):")
    for reg in REGS:
        rep = run_gemm(x, w, AcceleratorConfig(reg_size=reg))
        e = energy_from_stats(rep.stats)
        print(f"  reg={reg:2d} util={rep.utilization:.3f} "
              f"mapm={rep.mapm:.3f} tops/w="
              f"{tops_per_watt(rep.stats.macs, e.total_j):.3f} "
              f"deadlock_breaks={rep.stats.deadlock_breaks}")

    print("\nPE-array shape sweep (reg=8):")
    for am, an in ARRAYS:
        rep = run_gemm(x, w, AcceleratorConfig(array_m=am, array_n=an))
        e = energy_from_stats(rep.stats)
        print(f"  {am:2d}x{an:<2d} util={rep.utilization:.3f} "
              f"mapm={rep.mapm:.3f} tops/w="
              f"{tops_per_watt(rep.stats.macs, e.total_j):.3f}")
    print("OK")


if __name__ == "__main__":
    main()

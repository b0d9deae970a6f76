"""Quickstart of the PyTorch/CUDA port: the paper's pipeline end to end.

1. Build a sparse GEMM workload (75 % global-L1 pruned weights, as the
   paper prunes MobileNetV2).
2. Run it through the cycle-accurate EIM+SIDR accelerator model — get the
   paper's metrics (MAPM, utilisation, speed-up, TOPS/W) and verify the
   output against a dense matmul.
3. Pack the same weights into the bitmap format and run ``bitmap_spmm``
   against its plain version: on the card the hand-written kernel (K1),
   on the CPU (``--device cpu``) the plain version itself.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import run_gemm
from repro_torch.core.bitmap import prune_global_l1, random_sparse
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.sparse import pack_bitmap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a card); cpu runs "
                         "the plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # -- 1. sparse workload --------------------------------------------------
    x = random_sparse((128, 256), sparsity=0.45, rng=rng)      # activations
    w = prune_global_l1(rng.standard_normal((128, 256)).astype(np.float32),
                        sparsity=0.75)                          # weights

    # -- 2. the paper's accelerator -----------------------------------------
    report = run_gemm(x, w, compute_values=True)
    np.testing.assert_allclose(report.outputs, x @ w.T, atol=1e-4)
    print("accelerator (16x16 PE array, EIM + SIDR):")
    for k, v in report.summary().items():
        print(f"  {k:28s} {v}")

    # -- 3. the bitmap format through the kernel ----------------------------
    wt = torch.from_numpy(w.T.copy()).to(device)                # (K=256, N=128)
    bw = pack_bitmap(wt, block=(128, 128))
    xt = torch.from_numpy(x).float().to(device)
    out = ops.bitmap_spmm(xt, bw)
    expect = ref.bitmap_spmm_ref(xt, bw)
    err = float((out - expect).abs().max())
    print(f"\nbitmap_spmm on {device}: weight HBM compression "
          f"{bw.compression:.2f}x, max |err| vs plain version {err:.2e}")
    assert err < 1e-3
    print("OK")


if __name__ == "__main__":
    main()

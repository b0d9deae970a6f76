#!/usr/bin/env python3
"""Time two ways of building the PyTorch port's CUDA kernels.

Run from the root of the repository on a machine with the CUDA toolkit:

    python3 scripts/time_kernel_build.py [--reps 2]

(a) the port's build (``repro_torch.kernels._build.compile_library``):
    one ``nvcc`` per ``kernels/csrc/*.cu``, all started together, then
    one link;
(b) one ``nvcc -shared`` call over every source, with the same flags.

Both build into a temporary directory, so the library the port loads is
left alone; the runs alternate a, b, b, a, ...  Prints every time in
seconds and each way's mean, beside the machine's CPU count.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def parallel(out: pathlib.Path) -> None:
    _build.compile_library(out)


def single(out: pathlib.Path) -> None:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out), *map(str, _build.sources())],
                   check=True, capture_output=True, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    reps = ap.parse_args().reps
    ways = {"one nvcc per source, together, then one link": parallel,
            "one nvcc call over every source": single}
    times = {name: [] for name in ways}
    order = [name for r in range(reps)
             for name in (list(ways) if r % 2 == 0 else list(ways)[::-1])]
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(order):
            out = pathlib.Path(tmp) / f"kernels-{i}.so"
            t0 = time.perf_counter()
            ways[name](out)
            times[name].append(time.perf_counter() - t0)
            print(f"{name}: {times[name][-1]:.2f}s", flush=True)
    print(f"sources {[src.name for src in _build.sources()]}, "
          f"{os.cpu_count()} CPUs")
    for name, ts in times.items():
        print(f"mean over {len(ts)}: {sum(ts) / len(ts):.2f}s  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

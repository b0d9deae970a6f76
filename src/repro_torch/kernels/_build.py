"""Build of the port's CUDA kernels: every ``csrc/*.cu`` into one library.

Each source is compiled for ``sm_90a`` by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library
with a plain C interface under ``_build/``, named by a hash of every
file in ``csrc/`` and the flags; it is built at first use and loaded
with ``ctypes``.  Each kernel module types its own ``extern "C"`` entry
points with ``entry()`` and launches through the helpers below (the
card's SM count, the return-code check).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the entry points' type flags
TYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class Build:
    path: pathlib.Path
    log: str          # nvcc / ptxas output (registers, shared memory, spills)
    seconds: float    # 0.0 when the library was already built


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):     # headers count too
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def compile_library(out: pathlib.Path) -> str:
    """Compile every source (one ``nvcc`` each, all started together),
    link them into the shared library ``out`` and return nvcc's log."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        for src, proc in zip(sources(), procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        lib = pathlib.Path(tmp) / "kernels.so"
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                               str(lib), *map(str, objs)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernels:\n{log}")
        # atomic: a concurrent build never sees a partial library
        os.replace(lib, out)
    return log


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile and link the library once per hash of the sources."""
    out = BUILD_DIR / f"kernels-{_digest()}.so"
    if out.exists():
        return Build(out, "", 0.0)
    t0 = time.perf_counter()
    log = compile_library(out)
    return Build(out, log, time.perf_counter() - t0)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build().path))


@functools.lru_cache(maxsize=None)
def entry(name: str, *argtypes):
    """The library's ``extern "C"`` entry point ``name``, typed with
    ``argtypes`` and a trailing stream; it returns its launches'
    ``cudaGetLastError()`` (see ``check_launch``)."""
    fn = getattr(library(), name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card: the wrappers size their
    K splits by it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_launch(name: str, rc: int) -> None:
    """Raise on a C entry point's return code (its launches'
    ``cudaGetLastError()``)."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

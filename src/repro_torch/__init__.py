"""PyTorch/CUDA port of the sparse serving system in ``repro``.

The JAX package ``repro`` is the reference; this package computes the
same functions with PyTorch, and runs the bitmap-compressed products in
a hand-written CUDA kernel on an NVIDIA H100 (``kernels/``).  It imports
nothing of JAX and nothing of ``repro``.
"""

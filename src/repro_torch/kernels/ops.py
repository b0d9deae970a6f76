"""Public entry points of the kernel layer.

Dispatch follows the tensor: a CUDA tensor launches the hand-written
kernel (or the wrapper raises), a CPU tensor takes the plain PyTorch
version.  ``impl="torch"`` asks for the plain version explicitly, on any
device — a caller comparing the kernel with it does so; nothing falls
back to it silently.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmap_spmm as _bitmap_spmm
from repro_torch.kernels import ref as _ref
from repro_torch.sparse.format import BitmapWeight

IMPLS = ("cuda", "torch")


def default_impl(x: torch.Tensor) -> str:
    return "cuda" if x.is_cuda else "torch"


def bitmap_spmm(x: torch.Tensor, w: BitmapWeight, impl: str | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ W`` with W bitmap-compressed; x may be (..., K) — leading
    dims are flattened into the kernel's row dimension."""
    impl = impl or default_impl(x)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if impl == "cuda":
        out = _bitmap_spmm.bitmap_spmm(x2.contiguous(), w,
                                       out_dtype=out_dtype)
    else:
        out = _ref.bitmap_spmm_ref(x2, w, out_dtype=out_dtype)
    return out.reshape(*lead, w.shape[1])


def bitmap_spmm_grouped(x: torch.Tensor, w: BitmapWeight,
                        impl: str | None = None,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """``x[g] @ W_g`` over a group-stacked ``BitmapWeight`` (MoE expert
    stacks; ``sparse.format.pack_bitmap_experts``): x (G, M, K) ->
    (G, M, N), one kernel launch for all G groups on the card."""
    impl = impl or default_impl(x)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda":
        return _bitmap_spmm.bitmap_spmm_grouped(x.contiguous(), w,
                                                out_dtype=out_dtype)
    return _ref.bitmap_spmm_grouped_ref(x, w, out_dtype=out_dtype)

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
from repro_torch.kernels import block_sparse as _block_sparse
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import ref as _ref
from repro_torch.sparse.format import BitmapWeight, BlockSparseWeight

IMPLS = ("cuda", "torch")


def default_impl(x: torch.Tensor) -> str:
    return "cuda" if x.is_cuda else "torch"


def resolve_impl(x: torch.Tensor, impl: str | None) -> str:
    """``impl`` checked, or the tensor's default."""
    impl = impl or default_impl(x)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def flat_product(x: torch.Tensor, w, impl: str | None, kernel, plain,
                 out_dtype: torch.dtype | None) -> torch.Tensor:
    """``x @ W`` through ``kernel`` (the CUDA wrapper) or ``plain``, as
    ``impl`` says; x may be (..., K) — leading dims are flattened into the
    kernel's row dimension."""
    impl = resolve_impl(x, impl)
    x2 = x.reshape(-1, x.shape[-1])
    if impl == "cuda":
        out = kernel(x2.contiguous(), w, out_dtype=out_dtype)
    else:
        out = plain(x2, w, out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], w.shape[1])


def bitmap_spmm(x: torch.Tensor, w: BitmapWeight, impl: str | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ W`` with W bitmap-compressed; x may be (..., K)."""
    return flat_product(x, w, impl, _bitmap_spmm.bitmap_spmm,
                        _ref.bitmap_spmm_ref, out_dtype)


def bitmap_spmm_grouped(x: torch.Tensor, w: BitmapWeight,
                        impl: str | None = None,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """``x[g] @ W_g`` over a group-stacked ``BitmapWeight`` (MoE expert
    stacks; ``sparse.format.pack_bitmap_experts``): x (G, M, K) ->
    (G, M, N), one kernel launch for all G groups on the card."""
    impl = resolve_impl(x, impl)
    if impl == "cuda":
        return _bitmap_spmm.bitmap_spmm_grouped(x.contiguous(), w,
                                                out_dtype=out_dtype)
    return _ref.bitmap_spmm_grouped_ref(x, w, out_dtype=out_dtype)


def block_sparse_matmul(x: torch.Tensor, w: BlockSparseWeight,
                        impl: str | None = None,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """``x @ W`` with W block-sparse (``sparse.format.pack_block_sparse``);
    x may be (..., K)."""
    return flat_product(x, w, impl, _block_sparse.block_sparse_matmul,
                        _ref.block_sparse_matmul_ref, out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    impl: str | None = None, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Causal (or not) grouped-query attention with an optional sliding
    window: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    impl = resolve_impl(q, impl)
    if impl == "cuda":
        return _flash_attention.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window)
    return _ref.attention_ref(q, k, v, causal=causal, window=window)

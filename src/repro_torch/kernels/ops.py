"""Public entry points of the kernel layer.

Dispatch follows the tensor: a CUDA tensor launches the hand-written
kernel (or the wrapper raises), a CPU tensor takes the plain PyTorch
version.  ``impl="torch"`` asks for the plain version explicitly, on any
device — a caller comparing the kernel with it does so; nothing falls
back to it silently.

Under an active ``launch/counters.OpCounter`` every entry point here
(and ``kernels/nm_spmm.nm_spmm``) reports itself as one op
(``counting.counted``): dense FLOPs, its operands' and result's bytes
and the weight bytes its dispatch fetches; on meta tensors it returns an
empty result of the right shape without running.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.counting import counted, tensor_bytes
from repro_torch.kernels import bitmap_spmm as _bitmap_spmm
from repro_torch.kernels import block_sparse as _block_sparse
from repro_torch.kernels import decode_attention as _decode_attention
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bitmap_spmm import shard_slice
from repro_torch.sparse.format import (BitmapWeight, BlockSparseWeight,
                                       unshard_bitmap)

IMPLS = ("cuda", "torch")


def default_impl(x: torch.Tensor) -> str:
    return "cuda" if x.is_cuda else "torch"


def resolve_impl(x: torch.Tensor, impl: str | None) -> str:
    """``impl`` checked, or the tensor's default."""
    impl = impl or default_impl(x)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def weight_bytes(w, impl: str) -> int:
    """The weight bytes one product fetches: the compressed format's
    ``hbm_bytes`` on the card's kernel; the dense rendering the plain
    version multiplies by (a bitmap weight's ``dense_cache`` when it has
    one)."""
    if impl == "cuda":
        return w.hbm_bytes
    dense = getattr(w, "dense_cache", None)
    if dense is not None:
        return dense.numel() * dense.element_size()
    if isinstance(w, BitmapWeight):
        return w.dense_bytes
    return w.shape[0] * w.shape[1] * w.values.element_size()


def product_charge(counter, x: torch.Tensor, w, impl: str | None = None,
                   out_dtype: torch.dtype | None = None):
    """A product's charge for ``counted``: FLOPs 2·(rows)·K·N over every
    group, x's bytes and ``weight_bytes`` of the dispatch it takes (a
    meta call: ``impl`` or the counter's dispatch)."""
    impl = ((impl or counter.dispatch) if x.device.type == "meta"
            else resolve_impl(x, impl))
    return (2.0 * math.prod(x.shape[:-1]) * w.shape[0] * w.shape[1],
            tensor_bytes(x) + weight_bytes(w, impl),
            (*x.shape[:-1], w.shape[1]), out_dtype or x.dtype, x.device)


def _attention_charge(counter, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, impl: str | None = None, **_):
    """Attention's charge for ``counted``: 4·B·H·Sq·Skv·D FLOPs, q's,
    k's and v's bytes."""
    return (4.0 * math.prod(q.shape[:-1]) * k.shape[-2] * q.shape[-1],
            tensor_bytes(q) + tensor_bytes(k) + tensor_bytes(v), q.shape,
            q.dtype, q.device)


def _decode_attention_charge(counter, q: torch.Tensor,
                             k_cache: torch.Tensor, v_cache: torch.Tensor,
                             *_, **__):
    """Decode attention's charge for ``counted``: 4·B·Hq·C·D FLOPs and
    q's and the whole caches' bytes, as the reference's count of its
    einsums over every cache line."""
    b, c, _, d = k_cache.shape
    hq = q.shape[2]
    return (4.0 * b * hq * c * d,
            tensor_bytes(q) + tensor_bytes(k_cache) + tensor_bytes(v_cache),
            (b, 1, hq, d), q.dtype, q.device)


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


@counted("bitmap_spmm", product_charge)
def bitmap_spmm(x: torch.Tensor, w: BitmapWeight, impl: str | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ W`` with W bitmap-compressed; x may be (..., K).  A sharded
    W (``sparse.format.shard_bitmap``) takes one kernel launch per shard
    on the card (``_sharded_spmm``); the plain version unshards it
    first, which gives the same product."""
    if w.shard is None:
        return flat_product(x, w, impl, _bitmap_spmm.bitmap_spmm,
                            _ref.bitmap_spmm_ref, out_dtype)
    return flat_product(
        x, w, impl,
        lambda x2, w2, out_dtype: _sharded_spmm(
            x2, w2, _bitmap_spmm.bitmap_spmm, out_dtype),
        lambda x2, w2, out_dtype: _ref.bitmap_spmm_ref(
            x2, unshard_bitmap(w2), out_dtype=out_dtype),
        out_dtype)


def _contiguous(w: BitmapWeight) -> BitmapWeight:
    """``w`` with contiguous packed tensors (a grouped shard's slice is
    strided across its groups; the kernels read dense rows)."""
    return dataclasses.replace(
        w, packed_bits=w.packed_bits.contiguous(),
        values=w.values.contiguous(), row_start=w.row_start.contiguous())


def _sharded_spmm(x: torch.Tensor, w: BitmapWeight, kernel,
                  out_dtype: torch.dtype | None) -> torch.Tensor:
    """One ``kernel`` launch per shard of a sharded BitmapWeight: column
    shards each produce a contiguous N slice (concatenated); row shards
    each take a contiguous K slice of x and their partial products sum
    in float32, the sum a reduction across model-axis ranks performs.
    x's contraction axis is last ((M, K), or grouped (G, M, K))."""
    mode, shards = w.shard
    if mode == "col":
        return torch.cat([kernel(x, _contiguous(shard_slice(w, s)),
                                 out_dtype=out_dtype)
                          for s in range(shards)], dim=-1)
    ks = w.shape[0] // shards
    total = None
    for s in range(shards):
        part = kernel(x[..., s * ks:(s + 1) * ks].contiguous(),
                      _contiguous(shard_slice(w, s)),
                      out_dtype=torch.float32)
        total = part if total is None else total + part
    return total.to(out_dtype or x.dtype)


@counted("bitmap_spmm_grouped", product_charge)
def bitmap_spmm_grouped(x: torch.Tensor, w: BitmapWeight,
                        impl: str | None = None,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """``x[g] @ W_g`` over a group-stacked ``BitmapWeight`` (MoE expert
    stacks; ``sparse.format.pack_bitmap_experts``): x (G, M, K) ->
    (G, M, N), one kernel launch for all G groups on the card (one per
    shard of a sharded W)."""
    impl = resolve_impl(x, impl)
    if impl == "cuda":
        if w.shard is not None:
            return _sharded_spmm(x.contiguous(), w,
                                 _bitmap_spmm.bitmap_spmm_grouped,
                                 out_dtype)
        return _bitmap_spmm.bitmap_spmm_grouped(x.contiguous(), w,
                                                out_dtype=out_dtype)
    return _ref.bitmap_spmm_grouped_ref(x, unshard_bitmap(w),
                                        out_dtype=out_dtype)


@counted("block_sparse_matmul", product_charge)
def block_sparse_matmul(x: torch.Tensor, w: BlockSparseWeight,
                        impl: str | None = None,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """``x @ W`` with W block-sparse (``sparse.format.pack_block_sparse``);
    x may be (..., K)."""
    return flat_product(x, w, impl, _block_sparse.block_sparse_matmul,
                        _ref.block_sparse_matmul_ref, out_dtype)


@counted("flash_attention", _attention_charge)
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


@counted("decode_attention", _decode_attention_charge)
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     impl: str | None = None, *, window: int | None = None,
                     ring: bool = False) -> torch.Tensor:
    """Single-token attention against the slotted cache: q (B, 1, Hq, D),
    caches (B, C, Hkv, D), pos a scalar or (B,) -> (B, 1, Hq, D)
    (``kernels/decode_attention``)."""
    impl = resolve_impl(q, impl)
    if impl == "cuda":
        return _decode_attention.decode_attention(q, k_cache, v_cache, pos,
                                                  window=window, ring=ring)
    return _decode_attention.decode_attention_ref(q, k_cache, v_cache, pos,
                                                  window=window, ring=ring)

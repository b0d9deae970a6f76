"""Gradient compression for the data-parallel axis: int8 quantisation
with error feedback.

Port of ``repro/train/compression.py``: per-tensor-scaled int8 (scale
``max|g| / 127 + 1e-12``, round half to even, clipped to ±127) and the
residuals error feedback carries to the next step.  The all-reduce
around them (``compressed_psum_grads``, a ``shard_map`` over the data
axis in the reference) needs several devices and is not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.sparse.pruning import tree_items, tree_map


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any) -> Tuple[Any, Any, Any]:
    """Quantise a gradient tree; returns (q_tree, scales, residuals)."""
    parts = {}
    for path, g in tree_items(grads):
        q, s = quantize_int8(g.float())
        parts[path] = (q, s, g.float() - dequantize_int8(q, s))
    return tuple(tree_map(lambda p, _: parts[p][i], grads)
                 for i in range(3))


def decompress_tree(q_tree: Any, scales: Any) -> Any:
    flat = dict(tree_items(scales))
    return tree_map(lambda p, q: dequantize_int8(q, flat[p]), q_tree)


def compressed_psum_grads(grad_fn: Callable, mesh, axis: str = "data"
                          ) -> Callable:
    """The compressed data-parallel all-reduce runs across devices, which
    the port does not yet (ROADMAP queue 1 item 6, multiple GPUs)."""
    raise NotImplementedError(
        "compressed_psum_grads needs several devices: ROADMAP queue 1 "
        "item 6 (multiple GPUs)")


def init_error_fb(grads_like: Any, n_shards: int) -> Any:
    """Per-shard error-feedback state (leading shard dim)."""
    return tree_map(lambda _, g: torch.zeros((n_shards, *g.shape),
                                             dtype=torch.float32,
                                             device=g.device), grads_like)

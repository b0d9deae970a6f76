"""Gradient compression for the data-parallel axis: int8 quantisation
with error feedback.

Port of ``repro/train/compression.py``: per-tensor-scaled int8 (scale
``max|g| / 127 + 1e-12``, round half to even, clipped to ±127) and the
residuals error feedback carries to the next step.  The all-reduce
around them (``compressed_psum_grads``, a ``shard_map`` over the data
axis in the reference) runs over the ranks of a ``torch.distributed``
world: each rank computes its rows' gradients, and the int8 values
travel as int32 (the reference's arithmetic).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.sparse.format import all_reduce_sum
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
    """Wrap ``grad_fn(params, batch) -> grads`` so that each rank's
    gradients are int8-compressed before the all-reduce over ``axis``.

    Returns ``fn(params, batch, err) -> (grads, new_err)``, called alike
    on every rank of ``mesh``: ``params`` whole on every rank, ``batch``
    the whole batch (each rank takes its rows along dim 0), ``err`` the
    error-feedback state (``init_error_fb``'s (n, ...) leaves, of which
    the rank takes its row, or the rank's own (1, ...) row as ``fn``
    returns it).  Per rank: ``g + err`` is quantised, the int8 values
    summed as int32 and the scales summed and divided by n over the
    axis group; the grads are ``sum_q · mean_scale / n``, equal on every
    rank, and ``new_err`` the rank's residual with a leading dim of 1.
    A gloo group reduces a card's tensors through host memory."""
    n = mesh.shape[axis]
    idx = mesh.data_rank if axis == "data" else mesh.model_rank
    group = mesh.group(axis) if n > 1 else None

    def reduce(t):
        return all_reduce_sum(t, group) if group is not None else t

    def fn(params, batch, err):
        def rows(v):
            per = v.shape[0] // n
            return v[idx * per:(idx + 1) * per]

        local = tree_map(lambda _, v: rows(v), batch)
        flat_err = dict(tree_items(err))
        g = tree_map(lambda p, a: a.float() + (
            flat_err[p] if flat_err[p].shape[0] == 1
            else flat_err[p][idx:idx + 1])[0], grad_fn(params, local))
        q, scales, resid = compress_tree(g)
        flat_s = tree_items(scales)
        scale_sum = reduce(torch.stack([s for _, s in flat_s])) / n
        mean = {p: scale_sum[i] for i, (p, _) in enumerate(flat_s)}
        grads = tree_map(
            lambda p, qq: reduce(qq.to(torch.int32)).float() * mean[p] / n,
            q)
        return grads, tree_map(lambda _, r: r[None], resid)

    return fn


def init_error_fb(grads_like: Any, n_shards: int) -> Any:
    """Per-shard error-feedback state (leading shard dim)."""
    return tree_map(lambda _, g: torch.zeros((n_shards, *g.shape),
                                             dtype=torch.float32,
                                             device=g.device), grads_like)

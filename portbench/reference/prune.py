"""The pruning rule, frozen: global L1 magnitude pruning and per-tensor
magnitude pruning, written here so that the reference prunes the dense
weights itself.

Global: every leaf of two or more dimensions whose key path does not
name the embedding is prunable (as the parameter tree stores them: the
layer-stacked norm vectors are such leaves).  The threshold is the
``sparsity`` quantile of all prunable magnitudes, linearly interpolated
between the two order statistics around ``q·(n - 1)``, that index and
the interpolation taken in float32; an element whose magnitude is at or
below it becomes zero.  Per tensor: the threshold is the k-th smallest
magnitude, k = round(sparsity · numel).

An order statistic of a billion magnitudes comes from a histogram of
the top 16 bits of their float32 patterns (non-negative floats order as
those patterns do) and a sort of the one bucket that holds it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

_BUCKETS = 1 << 15
_PIECE = 1 << 26


def _pieces(tensors: Sequence[torch.Tensor]):
    for t in tensors:
        for piece in t.detach().reshape(-1).split(_PIECE):
            yield piece.abs().float()


def _bucket(mag: torch.Tensor) -> torch.Tensor:
    return mag.view(torch.int32) >> 16


def kth_smallest(tensors: Sequence[torch.Tensor], ks: Sequence[int]
                 ) -> List[float]:
    """The k-th smallest magnitude (1-based) over all ``tensors``, for
    each k of ``ks``."""
    device = tensors[0].device
    hist = torch.zeros(_BUCKETS, dtype=torch.int64, device=device)
    for mag in _pieces(tensors):
        hist += torch.bincount(_bucket(mag), minlength=_BUCKETS)
    cum = torch.cumsum(hist, 0).cpu()
    out = []
    for k in ks:
        b = int(torch.searchsorted(cum, torch.tensor(k)))
        below = int(cum[b - 1]) if b > 0 else 0
        vals = torch.cat([m[_bucket(m) == b] for m in _pieces(tensors)])
        out.append(float(torch.sort(vals).values[k - below - 1]))
    return out


def quantile(tensors: Sequence[torch.Tensor], q: float) -> torch.Tensor:
    """The linear-interpolated q-quantile of all magnitudes, as a float32
    scalar on the CPU."""
    n = sum(t.numel() for t in tensors)
    pos = torch.tensor(q, dtype=torch.float32) * (
        torch.tensor(float(n), dtype=torch.float32) - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1 - w_hi
    lo_i = int(min(max(lo.item(), 0), n - 1))
    hi_i = int(min(max(hi.item(), 0), n - 1))
    v_lo, v_hi = kth_smallest(tensors, [lo_i + 1, hi_i + 1])
    return (torch.tensor(v_lo, dtype=torch.float32) * w_lo
            + torch.tensor(v_hi, dtype=torch.float32) * w_hi)


def prunable(tree_leaves) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    return [(p, l) for p, l in tree_leaves
            if l.dim() >= 2 and not any("embed" in k.lower() for k in p)]


def zero_at_or_below(leaf: torch.Tensor, thresh: torch.Tensor) -> None:
    """Zero, in place, every element of ``leaf`` whose magnitude is at or
    below ``thresh``, a slice of the leading dimension at a time."""
    t = thresh.to(leaf.device, leaf.dtype)
    for part in (leaf.unbind(0) if leaf.dim() > 2 else (leaf,)):
        part.masked_fill_(part.abs() <= t, 0.0)


def global_prune_(tree_leaves, sparsity: float) -> Dict:
    """Prune the prunable leaves of ``tree_leaves`` ((path, leaf) pairs)
    in place to ``sparsity``; returns {path: kept count}."""
    cand = prunable(tree_leaves)
    thresh = quantile([l for _, l in cand], sparsity)
    kept = {}
    for path, leaf in cand:
        zero_at_or_below(leaf, thresh)
        kept[path] = int(torch.count_nonzero(leaf))
    return kept


def per_tensor_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """A pruned copy of ``w``: magnitudes at or below the k-th smallest,
    k = round(sparsity · numel), become zero."""
    k = int(round(sparsity * w.numel()))
    out = w.clone()
    if sparsity <= 0 or k <= 0:
        return out
    (t,) = kth_smallest([w], [k])
    zero_at_or_below(out, torch.tensor(t, dtype=torch.float32))
    return out

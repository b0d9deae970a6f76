"""Global L1 fine-grained pruning over nested dicts of tensors.

Port of ``repro/sparse/pruning.py``.  The prunable set, the global
threshold (linear-interpolated quantile of all prunable magnitudes) and
the ``<=`` prune are the reference's, so the same weights give the same
zero mask.  ``torch.quantile`` refuses inputs above 2**24 elements (full
olmo-1b has about 2**30), so the threshold is built from the two
neighbouring order statistics and interpolated the way ``jnp.quantile``
does it, in float32.  An order statistic comes from a 16-bit radix
histogram of the magnitudes' bit patterns and a sort of the one bucket
that holds it, which uses the whole card where ``kthvalue`` would run
one thread block over the whole input.  The histogram is summed over the
leaves, a piece at a time, and the bucket gathered from each: the
magnitudes are never concatenated, so a model of billions of prunable
weights (granite-moe: 3.2 G) needs no tensor above 2**28 elements.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, List, Sequence,
                    Tuple)

import torch


def tree_items(tree: Any, path: Tuple[str, ...] = ()
               ) -> List[Tuple[Tuple[str, ...], Any]]:
    """Leaves of a nested dict with their key paths, in sorted key order
    (the order ``jax.tree_util`` walks a dict)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def tree_map(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def keystr(path: Tuple[str, ...]) -> str:
    """The reference's ``jax.tree_util.keystr`` of a dict-key path."""
    return "".join(f"[{k!r}]" for k in path)


def _is_prunable(path: Tuple[str, ...], leaf: torch.Tensor,
                 predicate: Callable | None) -> bool:
    if leaf.dim() < 2:      # biases, norms, scalars stay dense
        return False
    if predicate is not None:
        return predicate(path, leaf)
    return "embed" not in keystr(path).lower()


# elements per piece of a leaf: bounds the float32 and int32 temporaries
_PIECE = 1 << 28
_BUCKETS = 1 << 15       # the top 16 bits of a non-negative float32


def _magnitudes(tensors: Sequence[torch.Tensor]) -> Iterator[torch.Tensor]:
    """Flat float32 |x| of each tensor, a piece at a time."""
    for t in tensors:
        for piece in t.detach().reshape(-1).split(_PIECE):
            yield piece.abs().float()


def _bucket(mag: torch.Tensor) -> torch.Tensor:
    # non-negative floats order as their int32 bit patterns do
    return mag.view(torch.int32) >> 16


class OrderStats:
    """Order statistics of the magnitudes of several tensors, as if they
    were one flat tensor.  A 16-bit radix histogram over all of them is
    built once; ``kth`` sorts only the bucket that holds rank k."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.tensors = list(tensors)
        self.n = sum(t.numel() for t in self.tensors)
        device = self.tensors[0].device
        hist = torch.zeros(_BUCKETS, dtype=torch.int64, device=device)
        for mag in _magnitudes(self.tensors):
            hist += torch.bincount(_bucket(mag), minlength=_BUCKETS)
        self.cum = torch.cumsum(hist, 0)

    def kth(self, k: int) -> torch.Tensor:
        """The k-th smallest (1-based) magnitude."""
        if not 1 <= k <= self.n:
            raise IndexError(f"k={k} outside [1, {self.n}]")
        bucket = int(torch.searchsorted(
            self.cum, torch.tensor(k, device=self.cum.device)))
        below = int(self.cum[bucket - 1]) if bucket > 0 else 0
        vals = torch.cat([m[_bucket(m) == bucket]
                          for m in _magnitudes(self.tensors)])
        return torch.sort(vals).values[k - below - 1]


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (1-based) of a 1-D non-negative float32 tensor."""
    return OrderStats([x]).kth(k)


def quantile(x: torch.Tensor | OrderStats, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (method "linear") of a 1-D non-negative
    float32 tensor (or of the magnitudes an ``OrderStats`` holds), with
    float32 index arithmetic as the reference."""
    stats = x if isinstance(x, OrderStats) else OrderStats([x])
    n = stats.n
    pos = torch.tensor(q, dtype=torch.float32) * (
        torch.tensor(float(n), dtype=torch.float32) - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1 - w_hi
    lo_i = int(min(max(lo.item(), 0), n - 1))
    hi_i = int(min(max(hi.item(), 0), n - 1))
    v_lo = stats.kth(lo_i + 1).cpu()
    v_hi = v_lo if hi_i == lo_i else stats.kth(hi_i + 1).cpu()
    return (v_lo * w_lo + v_hi * w_hi).to(stats.cum.device)


def global_l1_prune(params: Dict, sparsity: float,
                    predicate: Callable | None = None) -> Dict:
    """Zero the globally-smallest |w| fraction across all prunable leaves
    (returns new tensors; ``params`` is left as it was)."""
    if sparsity <= 0:
        return params
    prunable = [(p, l) for p, l in tree_items(params)
                if _is_prunable(p, l, predicate)]
    if not prunable:
        return params
    thresh = quantile(OrderStats([l for _, l in prunable]), sparsity)
    paths = {p for p, _ in prunable}

    def prune_leaf(path, leaf):
        if path in paths:
            return torch.where(leaf.abs() <= thresh.to(leaf.dtype),
                               torch.zeros((), dtype=leaf.dtype,
                                           device=leaf.device), leaf)
        return leaf

    return tree_map(prune_leaf, params)


def per_tensor_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Magnitude-prune a single tensor to exactly ``sparsity``."""
    if sparsity <= 0:
        return w
    k = int(round(sparsity * w.numel()))
    if k <= 0:
        return w
    thresh = kth_smallest(w.abs().reshape(-1).float(), k).to(w.dtype)
    return torch.where(w.abs() <= thresh, torch.zeros((), dtype=w.dtype,
                                                      device=w.device), w)


def sparsity_of(params: Dict) -> float:
    """Zero fraction over every leaf of two or more dimensions."""
    leaves = [l for _, l in tree_items(params)
              if isinstance(l, torch.Tensor) and l.dim() >= 2]
    total = sum(l.numel() for l in leaves)
    zeros = sum(int((l == 0).sum()) for l in leaves)
    return zeros / max(total, 1)

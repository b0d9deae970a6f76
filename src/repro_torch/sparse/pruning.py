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
one thread block over the whole input.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

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


def kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (1-based) of a 1-D non-negative float32 tensor.

    Non-negative floats order as their int32 bit patterns do, so the top
    16 bits pick a bucket; only the bucket holding rank k is sorted."""
    if not 1 <= k <= x.numel():
        raise IndexError(f"k={k} outside [1, {x.numel()}]")
    top = x.view(torch.int32) >> 16
    cum = torch.cumsum(torch.bincount(top, minlength=1 << 15), 0)
    bucket = int(torch.searchsorted(cum, torch.tensor(k, device=x.device)))
    below = int(cum[bucket - 1]) if bucket > 0 else 0
    return torch.sort(x[top == bucket]).values[k - below - 1]


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (method "linear") of a 1-D non-negative
    float32 tensor, with float32 index arithmetic as the reference."""
    n = x.numel()
    pos = torch.tensor(q, dtype=torch.float32) * (
        torch.tensor(float(n), dtype=torch.float32) - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1 - w_hi
    lo_i = int(min(max(lo.item(), 0), n - 1))
    hi_i = int(min(max(hi.item(), 0), n - 1))
    v_lo = kth_smallest(x, lo_i + 1).cpu()
    v_hi = v_lo if hi_i == lo_i else kth_smallest(x, hi_i + 1).cpu()
    return (v_lo * w_lo + v_hi * w_hi).to(x.device)


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
    mags = torch.cat([l.detach().abs().reshape(-1).float()
                      for _, l in prunable])
    thresh = quantile(mags, sparsity)
    del mags
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

"""Plain float32 masked sparse training: the reference for a training cell.

Loss: the token mean of the cross entropy of next-token targets (-1 is
no target) over the whole batch, logits from the tied head.  The
gradient is taken one batch row at a time (summed, then divided by the
batch's target count), so that the float32 activations of one row are
all that is held.  The masks are the pruned weights' non-zeros; each
step masks the gradient, clips it to ``clip_norm`` by its global norm,
takes AdamW (decoupled weight decay on every leaf but the norms; linear
warm-up, then cosine decay to ``min_lr_ratio``) and masks the weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from reference import module_of


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _rebuild(pairs) -> Dict:
    tree: Dict = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def loss_and_grads(params: Dict, model: Dict, tokens: torch.Tensor,
                   targets: torch.Tensor, quant: Optional[str] = None):
    """(loss, {path: grad}) over a (B, S) batch, one row at a time, by
    the forward pass of the configuration's reference module."""
    net = module_of(model)
    items = list(_leaves(params))
    grads = {p: torch.zeros_like(l) for p, l in items}
    count = int((targets >= 0).sum())
    total = 0.0
    for row in range(tokens.shape[0]):
        live = [(p, l.detach().requires_grad_(True)) for p, l in items]
        tree = _rebuild(live)
        ref = {"params": tree, "head": tree["embed"].t()}
        with torch.enable_grad():
            h = net.hidden(ref, model, tokens[row], quant)
            logits = net.matmul(h, ref["head"], quant)
            t = targets[row]
            keep = t >= 0
            ce = torch.nn.functional.cross_entropy(
                logits[keep], t[keep].long(), reduction="sum")
            gs = torch.autograd.grad(ce, [l for _, l in live],
                                     allow_unused=True)
        total += float(ce.detach())
        for (p, _), g in zip(live, gs):
            if g is not None:
                grads[p] += g
        del live, tree, ref, h, logits, gs
    for g in grads.values():
        g /= max(count, 1)
    return total / max(count, 1), grads


def lr_at(opt: Dict, step: int) -> float:
    warm = opt["warmup_steps"]
    if step < warm:
        return opt["lr"] * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    return opt["lr"] * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"])
                        * 0.5 * (1 + math.cos(math.pi * prog)))


def train(params: Dict, model: Dict, opt: Dict, batches: List,
          quant: Optional[str] = None, masked: bool = True,
          first_ref: Optional[Dict] = None, keep_first: bool = False
          ) -> Dict:
    """Masked AdamW steps from the pruned ``params`` (updated in place) on
    ``batches`` [(tokens, targets)].  Returns each step's loss and
    global gradient norm before clipping, each leaf's norm of the first
    step's clipped gradient and of its gradient before clipping, and
    each leaf's norm of the change over all the steps.  ``masked=False``
    skips both mask products (a fault: the pruned weights move).
    ``first_ref`` ({path: tensor}): each leaf's norm of the difference
    of the first clipped gradient from it is returned too;
    ``keep_first``: the first clipped gradient itself is returned."""
    items = list(_leaves(params))
    start = {p: l.clone() for p, l in items}
    masks = {p: (l != 0) for p, l in items}
    m = {p: torch.zeros_like(l) for p, l in items}
    v = {p: torch.zeros_like(l) for p, l in items}
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    losses, norms, first, first_raw = [], [], {}, {}
    first_diff, first_vec = {}, {}
    for i, (tokens, targets) in enumerate(batches):
        step = i + 1
        loss, grads = loss_and_grads(params, model, tokens, targets, quant)
        losses.append(loss)
        for p in grads:
            if masked:
                grads[p].mul_(masks[p])
        gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in
                              grads.values()))
        norms.append(gnorm)
        scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
        lr = lr_at(opt, step)
        with torch.no_grad():
            for p, leaf in items:
                g = grads[p] * scale
                if step == 1:
                    first[p] = float(torch.linalg.vector_norm(g))
                    first_raw[p] = float(torch.linalg.vector_norm(grads[p]))
                    if first_ref is not None:
                        first_diff[p] = float(torch.linalg.vector_norm(
                            g - first_ref[p]))
                    if keep_first:
                        first_vec[p] = g.clone()
                m[p].mul_(b1).add_((1 - b1) * g)
                v[p].mul_(b2).add_((1 - b2) * g * g)
                upd = (m[p] / (1 - b1 ** step)) / (
                    torch.sqrt(v[p] / (1 - b2 ** step)) + eps)
                if "norm" not in p[-1]:
                    upd = upd + opt["weight_decay"] * leaf
                leaf.sub_(lr * upd)
                if masked:
                    leaf.mul_(masks[p])
        del grads
    change = {p: float(torch.linalg.vector_norm(l - start[p]))
              for p, l in items}
    zeros = {p: int(l.numel() - torch.count_nonzero(l)) for p, l in items}
    return {"losses": losses, "grad_norms": norms, "first_grad": first,
            "first_grad_raw": first_raw, "change": change, "zeros": zeros,
            "first_grad_diff": first_diff, "first_grad_vec": first_vec}

"""AdamW + global-norm clipping + cosine schedule over nested dicts of
tensors.

Port of ``repro/train/optimizer.py``.  The arithmetic is the
reference's, in float32 and in its order; the update is written into the
parameter and moment tensors in place (the reference donates its
buffers), so a step allocates only one leaf's temporaries at a time.
The step counter, the learning rate and the gradient norm stay on the
parameters' device: a step needs no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.sparse.pruning import keystr, tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``·lr (float32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Any) -> Dict:
    """Zero float32 moments shaped as ``params`` and an int32 step."""
    leaves = [l for _, l in tree_items(params)]
    device = leaves[0].device if leaves else None
    zeros = lambda path, p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in the reference's (sorted-key) order."""
    total = 0
    for _, leaf in tree_items(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def _decay_mask(path) -> bool:
    """Weight decay only on matrices (not norms/biases/ssm scalars)."""
    name = keystr(path).lower()
    return not any(k in name for k in
                   ("norm", "bias", "a_log", "mu", "['u']", "w0", "gn_scale",
                    "conv_b", "['d']"))


@torch.no_grad()
def update(params: Any, grads: Any, state: Dict, cfg: OptConfig,
           gnorm: Optional[torch.Tensor] = None) -> Tuple[Any, Dict, Dict]:
    """One AdamW step, written into ``params`` and ``state`` in place.
    Returns (params, state, {"grad_norm", "lr"}) — the same objects
    passed in, updated.  ``gnorm``: the norm to clip by, when ``grads``
    is a slice of the whole gradient (a sharded step updating its part);
    None takes ``global_norm(grads)``."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

    flat_g = tree_items(grads)
    flat_p = [l for _, l in tree_items(params)]
    flat_m = [l for _, l in tree_items(state["m"])]
    flat_v = [l for _, l in tree_items(state["v"])]
    for (path, g), p, m, v in zip(flat_g, flat_p, flat_m, flat_v):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        del g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path):
            upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

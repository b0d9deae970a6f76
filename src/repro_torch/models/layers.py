"""Neural building blocks over dicts of tensors (decode path).

Port of the decode-path functions of ``repro/models/layers.py`` with the
reference's cast order: norms, RoPE, attention scores, softmax and every
accumulator in float32; activations and the KV cache in the compute
type.  A product the reference asks of XLA with
``preferred_element_type=float32`` is taken here on float32 copies of
its operands — exact for bfloat16 inputs, whose products fit in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def norm(x: torch.Tensor, scale: Optional[torch.Tensor],
         kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        if scale is not None:
            y = y * (1.0 + scale.float())
    elif kind in ("ln_nonparam", "ln"):
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        if kind == "ln" and scale is not None:
            y = y * (1.0 + scale.float())
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S).  Halves are
    rotated as a pair (not interleaved), as in the reference."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, Hq, D); caches: (B, C, Hkv, D); pos: scalar position or a
    (B,) vector of per-slot positions.  ``ring`` marks a sliding-window
    ring buffer of size C == window.
    """
    b, c, hkv, d = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qh = q[:, 0].reshape(b, hkv, g, d).to(k_cache.dtype)
    s = torch.einsum("bkgd,bckd->bkgc", qh.float(), k_cache.float()) * scale
    s = s.reshape(b, hq, c)
    pc = pos.expand(b) if pos.dim() == 0 else pos
    pc = pc.to(torch.int64)[:, None]
    slots = torch.arange(c, device=q.device)[None, :]
    if ring:
        # slot i holds the latest position p <= pos with p % C == i;
        # cold slots imply p < 0 and are masked out
        base = pc - (pc % c)
        slot_pos = torch.where(slots <= (pc % c), base + slots,
                               base - c + slots)
    else:
        slot_pos = slots.expand(b, c)
    valid = (slot_pos <= pc) & (slot_pos >= 0)
    if window is not None:
        valid &= (pc - slot_pos) < window
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1).reshape(b, hkv, g, c)
    out = torch.einsum("bkgc,bckd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def slot_kv_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   write_slot: torch.Tensor) -> None:
    """Write one K/V line per batch row into the contiguous slotted cache,
    in place (the reference returns new arrays; here the cache tensors
    are updated where they lie, so no cache is copied per step).

    k_cache/v_cache: (B, C, Hkv, D); k/v: (B, 1, Hkv, D); write_slot: (B,).
    """
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[bidx, write_slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, write_slot] = v[:, 0].to(v_cache.dtype)


def matmul_or_bitmap(h: torch.Tensor, w: torch.Tensor, bw,
                     impl: Optional[str]) -> torch.Tensor:
    """One projection: dense ``h @ w`` unless a packed ``BitmapWeight``
    is given, in which case the product streams the compressed form
    through ``kernels/ops.bitmap_spmm`` (the CUDA kernel on the card)."""
    if bw is None:
        return h @ w.to(h.dtype)
    from repro_torch.kernels import ops
    return ops.bitmap_spmm(h, bw, impl=impl)


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
        packed: Optional[dict] = None,
        impl: Optional[str] = None) -> torch.Tensor:
    """Gated or plain MLP; ``packed`` maps weight names to
    ``BitmapWeight``s (serve-time compressed streaming)."""
    pk = packed or {}
    if "w_gate" in params:
        h = activation(matmul_or_bitmap(x, params["w_gate"],
                                        pk.get("w_gate"), impl), cfg.act)
        h = h * matmul_or_bitmap(x, params["w_up"], pk.get("w_up"), impl)
    else:
        h = activation(matmul_or_bitmap(x, params["w_up"],
                                        pk.get("w_up"), impl), cfg.act)
    return matmul_or_bitmap(h, params["w_down"], pk.get("w_down"), impl)

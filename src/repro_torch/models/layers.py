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

from repro_torch.counting import span
from repro_torch.kernels import ops
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


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """Per-head group norm (the RWKV output norm) in float32, eps 1e-5,
    with the population variance (``jnp.var``'s; torch's default is the
    unbiased one).  x: (..., H·Dh)."""
    shp = x.shape
    xf = x.reshape(*shp[:-1], heads, shp[-1] // heads).float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y.reshape(shp) * scale.float()).to(x.dtype)


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


def _online_block(carry, kc, vc, q, q_pos, k_pos, window, scale):
    """One online-softmax step over a KV chunk.  q: (B, Hkv, Sq, D)
    float32; kc, vc: (B, Hkv, C, D) float32; q_pos (B, Sq), k_pos (B, C)."""
    m_prev, l_prev, acc = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q, kc) * scale
    mask = q_pos[:, None, :, None] >= k_pos[:, None, None, :]
    if window is not None:
        mask = mask & ((q_pos[:, None, :, None] - k_pos[:, None, None, :])
                       < window)
    s = torch.where(mask, s, torch.full((), -1e30, device=s.device))
    m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(-1, keepdim=True)
    acc_new = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", p, vc)
    return m_new, l_new, acc_new


def scan_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, *, window: Optional[int] = None,
                   q_chunk: int = 2048, kv_chunk: int = 512) -> torch.Tensor:
    """Causal flash-style attention in plain torch (the training path's
    attention; differentiable).  q: (B, S, Hq, D); k, v: (B, S, Hkv, D);
    positions: (B, S).

    The reference's algorithm step for step: GQA folded into the query
    sequence (s-major) so KV is never repeated; a loop over query chunks,
    each over only its causally reachable KV chunks (from ``kv_lo`` under
    a window), the tail chunk zero-padded; ``-1e30`` masks; scores,
    softmax state and accumulators in float32; ``acc / max(l, 1e-30)``.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    qh = (q.reshape(b, s, hkv, g, d).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, s * g, d).float())
    kh = k.transpose(1, 2).float()                       # (B, Hkv, S, D)
    vh = v.transpose(1, 2).float()

    outs = []
    for q0 in range(0, s, q_chunk):
        q1 = min(q0 + q_chunk, s)
        qc = qh[:, :, q0 * g:q1 * g]
        qp = positions[:, q0:q1].repeat_interleave(g, dim=1)
        kv_lo = (max(0, (q0 - window + 1) // kv_chunk * kv_chunk)
                 if window is not None else 0)
        n_kv = -(-(q1 - kv_lo) // kv_chunk)
        kv_len = n_kv * kv_chunk
        kc = kh[:, :, kv_lo:kv_lo + kv_len]
        vc = vh[:, :, kv_lo:kv_lo + kv_len]
        if kc.shape[2] < kv_len:                         # pad the tail chunk
            pad = (0, 0, 0, kv_len - kc.shape[2])
            kc, vc = F.pad(kc, pad), F.pad(vc, pad)
        kp = kv_lo + torch.arange(kv_len, device=q.device)
        qn = (q1 - q0) * g
        carry = (torch.full((b, hkv, qn, 1), -1e30, device=q.device),
                 torch.zeros((b, hkv, qn, 1), device=q.device),
                 torch.zeros((b, hkv, qn, d), device=q.device))
        for c0 in range(0, kv_len, kv_chunk):
            sl = slice(c0, c0 + kv_chunk)
            carry = _online_block(carry, kc[:, :, sl], vc[:, :, sl], qc, qp,
                                  kp[sl].expand(b, kv_chunk), window, scale)
        _, l, acc = carry
        outs.append(acc / l.clamp_min(1e-30))
    out = torch.cat(outs, dim=2)                         # (B, Hkv, S·g, D)
    out = (out.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4)
           .reshape(b, s, hq, d))
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None,
                     ring: bool = False,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Single-token attention against a cache, through the kernel layer
    (``kernels/ops.decode_attention``: the hand-written kernel on the
    card, its plain version on the CPU or with ``impl="torch"``).

    q: (B, 1, Hq, D); caches: (B, C, Hkv, D); pos: scalar position or a
    (B,) vector of per-slot positions.  ``ring`` marks a sliding-window
    ring buffer over the C lines: C == window in the contiguous layout,
    C >= window in the paged one (page_slots × page_len rounds the
    window up to whole pages).  The ring addresses position p at line
    p % C, and ``window`` masks lines older than the window on its own,
    so the padded lines past the window are never attended.
    """
    with span("attn.decode"):
        return ops.decode_attention(q, k_cache, v_cache, pos, impl,
                                    window=window, ring=ring)


def slot_kv_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   write_slot: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> None:
    """Write one K/V line per batch row into the contiguous slotted cache,
    in place (the reference returns new arrays; here the cache tensors
    are updated where they lie, so no cache is copied per step).

    k_cache/v_cache: (B, C, Hkv, D); k/v: (B, 1, Hkv, D); write_slot: (B,).
    ``valid`` ((B,) bool) masks rows off: chunked prefill's padding lanes
    write nothing.  A masked row writes back the line it finds, so the
    update needs no host sync to count the valid rows.
    """
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    knew = k[:, 0].to(k_cache.dtype)
    vnew = v[:, 0].to(v_cache.dtype)
    if valid is not None:
        keep = valid[:, None, None]
        knew = torch.where(keep, knew, k_cache[bidx, write_slot])
        vnew = torch.where(keep, vnew, v_cache[bidx, write_slot])
    k_cache[bidx, write_slot] = knew
    v_cache[bidx, write_slot] = vnew


def paged_kv_update(k_pool: torch.Tensor, v_pool: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    page_table: torch.Tensor, write_slot: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> None:
    """Write one K/V line per batch row through a page table, in place.

    k_pool/v_pool: (NP, L, Hkv, D) page pools (page 0 is the trash
    page); k/v: (B, 1, Hkv, D); page_table: (B, S) physical page ids, 0
    = unmapped; write_slot: (B,) logical line in [0, S·L).  Rows whose
    page is unmapped, and rows ``valid`` masks off, resolve to page 0
    and write the trash line: a masked row's own entry may be a page it
    shares copy-on-write, so it must not write there even the bytes it
    finds.  Idle rows all land on page 0, where duplicate targets are
    harmless: nothing reads the trash page as a valid line.
    """
    page_len = k_pool.shape[1]
    pi = write_slot // page_len
    off = write_slot % page_len
    phys = torch.gather(page_table, 1, pi[:, None])[:, 0]
    if valid is not None:
        phys = torch.where(valid, phys, torch.zeros_like(phys))
    k_pool[phys, off] = k[:, 0].to(k_pool.dtype)
    v_pool[phys, off] = v[:, 0].to(v_pool.dtype)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Each slot's pages as one contiguous (B, S·L, Hkv, D) view.
    Unmapped entries gather the trash page, whose lines the attention
    validity mask always excludes."""
    b, s = page_table.shape
    lines = pool.index_select(0, page_table.reshape(-1))
    return lines.reshape(b, s * pool.shape[1], *pool.shape[2:])


def matmul_or_bitmap(h: torch.Tensor, w: torch.Tensor, bw,
                     impl: Optional[str]) -> torch.Tensor:
    """One projection: dense ``h @ w`` unless a packed ``BitmapWeight``
    is given, in which case the product streams the compressed form
    through ``kernels/ops.bitmap_spmm`` (the CUDA kernel on the card)."""
    if bw is None:
        return h @ w.to(h.dtype)
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


# ----------------------------------------------------------------- MoE -----


def expert_matmul_or_bitmap(h: torch.Tensor, w: torch.Tensor, bw,
                            impl: Optional[str]) -> torch.Tensor:
    """Per-expert product ``h[..., e, :, :] @ w[e]``: h (..., E, C, K),
    w (E, K, N).  A group-stacked ``BitmapWeight`` streams every
    expert's compressed tiles through ``kernels/ops.bitmap_spmm_grouped``
    (one kernel launch for all experts on the card) with the rows of all
    leading dims folded into each expert's M."""
    if bw is None:
        return torch.einsum("...eck,ekn->...ecn", h, w.to(h.dtype))
    lead = h.shape[:-3]
    e, c, k = h.shape[-3:]
    hx = h.reshape(-1, e, c, k).transpose(0, 1).reshape(e, -1, k)
    out = ops.bitmap_spmm_grouped(hx, bw, impl=impl)
    n = out.shape[-1]
    return out.reshape(e, -1, c, n).transpose(0, 1).reshape(*lead, e, c, n)


def top_k_lower_index(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    toward the lower index (``torch.topk`` promises no order).  A stable
    descending sort keeps equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
            packed: Optional[dict] = None,
            impl: Optional[str] = None,
            global_dispatch: bool = False) -> torch.Tensor:
    """Sort-based top-k MoE with static per-row capacity (the reference's
    ``moe_ffn``): x (B, S, D) -> (B, S, D).  ``global_dispatch`` (baseline
    mode, ``perf_flags``, resolved where the step is built) takes
    ``_moe_ffn_global`` instead.

    Each batch row dispatches on its own: capacity
    ``int(S·k·cf / E) + 1``, tokens past an expert's capacity dropped.
    Router softmax in float32; top-k with ties toward the lower expert;
    gates renormalised by ``max(sum, 1e-9)``; a stable argsort by expert
    and ``searchsorted`` ranks; the bucket scatter; three expert
    products (grouped kernel when ``packed`` holds the stacks); and the
    float32 combine.  The combine sums each token's k contributions in
    ascending expert order — the order the reference's scatter-add
    applies them in (updates sorted by expert) — as a fixed sequence of
    adds, so it is deterministic on the card and equal to the reference
    in float32.  Every step is sync-free on the card.
    """
    if global_dispatch:
        return _moe_ffn_global(params, x, cfg, packed=packed, impl=impl)
    return _moe_rows(params, x, cfg, packed, impl)


def _moe_ffn_global(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    packed: Optional[dict] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """The reference's baseline dispatch: one argsort over all B·S
    tokens, capacity ``int(B·S·k·cf / E) + 1`` for the whole batch, the
    ``keep`` mask, the bucket scatter, the expert products (K1g on the
    card for packed stacks) and the float32 scatter-add back.  That is
    the per-row dispatch of the batch flattened into one row of B·S
    tokens: the same sort, ranks, buckets and combine order."""
    b, s, d = x.shape
    return _moe_rows(params, x.reshape(1, b * s, d), cfg, packed,
                     impl).reshape(b, s, d)


def _moe_rows(params: dict, x: torch.Tensor, cfg: ModelConfig,
              packed: Optional[dict], impl: Optional[str]) -> torch.Tensor:
    """The dispatch of ``moe_ffn``, each of x's rows on its own."""
    with span("moe"):
        pk = packed or {}
        b, s, d = x.shape
        e, k = cfg.num_experts, cfg.top_k
        cap = int(s * k * cfg.capacity_factor / e) + 1
        dev = x.device

        logits = matmul_or_bitmap(x, params["router"], pk.get("router"), impl)
        probs = torch.softmax(logits.float(), dim=-1)
        gate, expert_idx = top_k_lower_index(probs, k)            # (B, S, k)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

        flat_e = expert_idx.reshape(b, s * k)
        order = torch.argsort(flat_e, dim=-1, stable=True)         # (B, S*k)
        sorted_e = torch.gather(flat_e, 1, order)
        # rank within an expert = position - its first occurrence
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        rank = torch.arange(s * k, device=dev)[None, :] - first
        keep = rank < cap
        slot = sorted_e * cap + torch.where(keep, rank, 0)         # (B, S*k)
        src = order // k                                            # token id

        rows = torch.arange(b, device=dev)[:, None].expand(b, s * k)
        gathered = torch.gather(x, 1, src[..., None].expand(b, s * k, d))
        # one real row per kept slot; dropped entries add zeros
        buf = torch.zeros((b, e * cap, d), dtype=x.dtype, device=dev)
        buf.index_put_((rows, slot),
                       torch.where(keep[..., None], gathered,
                                   torch.zeros((), dtype=x.dtype, device=dev)),
                       accumulate=True)
        buf = buf.reshape(b, e, cap, d)

        h = activation(expert_matmul_or_bitmap(
            buf, params["w_gate"], pk.get("w_gate"), impl), cfg.act)
        h = h * expert_matmul_or_bitmap(buf, params["w_up"], pk.get("w_up"),
                                        impl)
        y = expert_matmul_or_bitmap(h, params["w_down"], pk.get("w_down"),
                                    impl).reshape(b, e * cap, d)

        return moe_combine(y, slot, keep, order, gate, expert_idx).to(x.dtype)


def moe_combine(y: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                order: torch.Tensor, gate: torch.Tensor,
                expert_idx: torch.Tensor) -> torch.Tensor:
    """The MoE combine, in float32: token t's output is the sum over its
    k experts of ``gate · y[slot]`` (zero where dropped at capacity).

    y (B, E·cap, D); slot, keep, order (B, S·k) in sorted-by-expert
    order; gate, expert_idx (B, S, k).  The reference scatter-adds the
    terms in sorted order, so each token's k terms arrive by ascending
    expert; here they are gathered into that order and added one after
    another from zero — the same float32 sum, with no atomics.
    """
    b, s, k = gate.shape
    d = y.shape[-1]
    # each flat entry (t, j)'s place in the sorted order
    inv = torch.argsort(order, dim=-1)
    slot_f = torch.gather(slot, 1, inv)
    keep_f = torch.gather(keep, 1, inv)
    out_tok = torch.gather(y, 1, slot_f[..., None].expand(b, s * k, d))
    contrib = torch.where(keep_f[..., None], out_tok,
                          torch.zeros((), dtype=y.dtype, device=y.device))
    contrib = (contrib.float() * gate.reshape(b, s * k, 1)).reshape(
        b, s, k, d)
    by_expert = torch.argsort(expert_idx, dim=-1)
    contrib = torch.gather(contrib, 2,
                           by_expert[..., None].expand(b, s, k, d))
    out = torch.zeros((b, s, d), dtype=torch.float32, device=y.device)
    for j in range(k):
        out = out + contrib[:, :, j]
    return out

"""Decoder LM: shapes, init, full-sequence forward and loss, cache, decode.

Port of ``repro/models/model.py``.  Parameters are a nested dict of
tensors with the reference's path names, block leaves stacked over
periods (leading dim P).  The reference's ``lax.scan`` over periods
becomes a Python loop over the period index.

Training: ``forward`` runs the full sequence (``scan_attention``, the
full-sequence mixers, MoE at per-row capacity) with each period under
``torch.utils.checkpoint`` when ``cfg.remat``; ``lm_loss`` is the
sequence-chunked cross entropy, each chunk checkpointed so its (B,
chunk, V) logits are not kept.  Serving: the decode step and chunked
prefill update the cache in place; attention mixers with MLP, MoE (or
no) FFNs run on both, over the contiguous cache or the paged one (page
pools read and written through per-slot page tables,
``serve/paging.py``).  Mamba and RWKV6 mixers and the RWKV channel-mix
(``models/ssm.py``) run on the decode path, their state slotted beside
the KV cache; chunked prefill has no path for them and raises, as the
reference's does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.config import BlockCfg, ModelConfig
from repro_torch.sparse.format import BitmapWeight
from repro_torch.sparse.pruning import keystr, tree_items

RWKV_MIX_RANK = 32
RWKV_DECAY_RANK = 64

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ------------------------------------------------------------- shapes ------


def _block_shapes(cfg: ModelConfig, blk: BlockCfg) -> Dict[str, dict]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    f = cfg.d_ff
    shp: Dict[str, dict] = {}
    if blk.mixer == "attn":
        shp["attn"] = {
            "norm": (d,), "wq": (d, h * hd), "wk": (d, kv * hd),
            "wv": (d, kv * hd), "wo": (h * hd, d),
        }
        if cfg.qk_norm:
            shp["attn"]["q_norm"] = (hd,)
            shp["attn"]["k_norm"] = (hd,)
    elif blk.mixer == "mamba":
        di, n, dtr = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_dt_rank
        shp["mamba"] = {
            "norm": (d,), "in_proj": (d, 2 * di),
            "conv_w": (di, cfg.mamba_conv), "conv_b": (di,),
            "x_proj": (di, dtr + 2 * n), "dt_proj": (dtr, di),
            "dt_bias": (di,), "A_log": (di, n), "D": (di,),
            "out_proj": (di, d),
        }
    elif blk.mixer == "rwkv":
        hh = cfg.rwkv_heads
        shp["rwkv"] = {
            "norm": (d,), "mix_mu": (5, d),
            "mix_A": (d, 5 * RWKV_MIX_RANK),
            "mix_B": (5, RWKV_MIX_RANK, d),
            "w0": (d,), "decay_A": (d, RWKV_DECAY_RANK),
            "decay_B": (RWKV_DECAY_RANK, d),
            "w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
            "w_o": (d, d), "u": (hh, cfg.rwkv_head_dim), "gn_scale": (d,),
        }
    else:
        raise ValueError(blk.mixer)

    if blk.ffn == "mlp":
        shp["mlp"] = {"norm": (d,), "w_up": (d, f), "w_down": (f, d)}
        if cfg.act == "silu":
            shp["mlp"]["w_gate"] = (d, f)
    elif blk.ffn == "moe":
        e = cfg.num_experts
        shp["moe"] = {
            "norm": (d,), "router": (d, e), "w_gate": (e, d, f),
            "w_up": (e, d, f), "w_down": (e, f, d),
        }
    elif blk.ffn == "rwkv_cm":
        shp["rwkv_cm"] = {"norm": (d,), "cm_mu": (2, d), "cm_k": (d, f),
                          "cm_v": (f, d), "cm_r": (d, d)}
    elif blk.ffn != "none":
        raise ValueError(blk.ffn)
    return shp


def param_shapes(cfg: ModelConfig) -> Dict:
    """Nested dict of shape tuples (block leaves stacked over periods)."""
    p = cfg.num_periods
    blocks = {}
    for i, blk in enumerate(cfg.pattern):
        blocks[f"b{i}"] = {comp: {name: (p,) + s for name, s in t.items()}
                           for comp, t in _block_shapes(cfg, blk).items()}
    shapes = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm": (cfg.d_model,),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def param_structs(cfg: ModelConfig) -> Dict:
    """The params as meta tensors (shape and dtype, no storage): the
    reference's ``ShapeDtypeStruct`` tree, the dry run's allocation-free
    inputs."""
    return _meta_tree(param_shapes(cfg), DTYPES[cfg.param_dtype])


def _meta_tree(shapes: Dict, dt: torch.dtype) -> Dict:
    return {k: (torch.empty(v, dtype=dt, device="meta")
                if isinstance(v, tuple) else _meta_tree(v, dt))
            for k, v in shapes.items()}


def _set(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> Dict:
    """Random parameters with the reference's per-name rules and scales,
    drawn from ``generator`` (which must live on ``device``: ``cuda``
    unless named, ``NoCudaDevice`` without a card)."""
    device = resolve_device(device)
    dt = DTYPES[cfg.param_dtype]
    depth_scale = 1.0 / math.sqrt(2 * cfg.num_layers)
    leaves = [(p, s) for p, s in tree_items(param_shapes(cfg))]

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    out: Dict = {}
    for path, shape in leaves:
        name = keystr(path).lower()
        if "a_log" in name:
            n = shape[-1]
            leaf = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                          device=device)).expand(shape)
        elif "dt_bias" in name:
            leaf = torch.full(shape, math.log(math.expm1(0.01)),
                              device=device)
        elif "mix_mu" in name or name.endswith("['u']"):
            leaf = torch.full(shape, 0.5, device=device)
        elif "w0" in name:
            leaf = -1.0 + 0.5 * normal(shape)
        elif "gn_scale" in name or "cm_mu" in name:
            leaf = torch.full(shape, 1.0 if "gn" in name else 0.5,
                              device=device)
        elif "norm" in name:
            leaf = torch.zeros(shape, device=device)
        elif "conv_b" in name or name.endswith("['d']"):
            leaf = (torch.zeros(shape, device=device) if "conv" in name
                    else torch.ones(shape, device=device))
        elif "embed" in name:
            leaf = 0.02 * normal(shape)
        elif any(k in name for k in ("wo", "out_proj", "w_down", "w_o")):
            leaf = (0.02 * depth_scale) * normal(shape)
        else:
            leaf = 0.02 * normal(shape)
        _set(out, path, leaf.to(dt).contiguous())
    return out


def embed_inputs(params: Dict, cfg: ModelConfig,
                 tokens: Optional[torch.Tensor],
                 embeds: Optional[torch.Tensor]) -> torch.Tensor:
    dt = DTYPES[cfg.compute_dtype]
    parts = []
    if embeds is not None:
        parts.append(embeds.to(dt))
    if tokens is not None:
        e = params["embed"][tokens].to(dt)
        if cfg.embed_scale:
            e = e * math.sqrt(cfg.d_model)
        parts.append(e)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


# ------------------------------------------------------------ forward ------


def _apply_attn(p: Dict, x: torch.Tensor, cfg: ModelConfig, blk: BlockCfg,
                positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dt_ = x.dtype
    xn = L.norm(x, p.get("norm"), cfg.norm)
    q = (xn @ p["wq"].to(dt_)).reshape(b, s, h, hd)
    k = (xn @ p["wk"].to(dt_)).reshape(b, s, kv, hd)
    v = (xn @ p["wv"].to(dt_)).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = L.norm(q, p["q_norm"], "rmsnorm")
        k = L.norm(k, p["k_norm"], "rmsnorm")
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    o = L.scan_attention(q, k, v, positions, window=blk.window)
    return o.reshape(b, s, h * hd) @ p["wo"].to(dt_)


def _apply_block(bp: Dict, x: torch.Tensor, blk: BlockCfg, cfg: ModelConfig,
                 positions: torch.Tensor,
                 moe_global: bool = False) -> torch.Tensor:
    """One block over the full sequence: x + mixer, then x + FFN.  MoE
    routes each batch row on its own at capacity ``int(S·k·cf/E) + 1``
    (``moe_global``: all B·S tokens at once, ``L._moe_ffn_global``)."""
    if blk.mixer == "attn":
        x = x + _apply_attn(bp["attn"], x, cfg, blk, positions)
    elif blk.mixer == "mamba":
        xn = L.norm(x, bp["mamba"].get("norm"), cfg.norm)
        x = x + ssm.mamba_mix(bp["mamba"], xn, cfg)
    elif blk.mixer == "rwkv":
        xn = L.norm(x, bp["rwkv"].get("norm"), cfg.norm)
        x = x + ssm.rwkv_mix(bp["rwkv"], xn, cfg)

    if blk.ffn == "mlp":
        xn = L.norm(x, bp["mlp"].get("norm"), cfg.norm)
        x = x + L.mlp(bp["mlp"], xn, cfg)
    elif blk.ffn == "moe":
        xn = L.norm(x, bp["moe"].get("norm"), cfg.norm)
        x = x + L.moe_ffn(bp["moe"], xn, cfg, global_dispatch=moe_global)
    elif blk.ffn == "rwkv_cm":
        xn = L.norm(x, bp["rwkv_cm"].get("norm"), cfg.norm)
        x = x + ssm.rwkv_channel_mix(bp["rwkv_cm"], xn)
    return x


def _unbind_periods(tree: Dict) -> list:
    """The P per-period trees of a period-stacked tree, one ``unbind``
    per leaf: the backward pass stacks the P slices' gradients once,
    where indexing each period would make a zero-filled gradient of the
    whole stacked leaf per period and sum the P of them."""
    if isinstance(tree, dict):
        subs = {k: _unbind_periods(v) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return tree.unbind(0)


def forward(params: Dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            moe_global: bool = False) -> torch.Tensor:
    """Final hidden states (B, S, D) after the final norm.  ``moe_global``
    (baseline mode, ``perf_flags``): the MoE blocks dispatch globally.

    Each period takes its slice of the period-stacked leaves
    (``_unbind_periods``), so gradients flow into the stacked leaf.  With
    ``cfg.remat`` each period runs under a non-reentrant ``checkpoint``
    and only its input is kept for the backward pass, as the reference's
    ``jax.checkpoint`` with ``nothing_saveable``."""
    x = embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    periods = _unbind_periods(params["blocks"])

    def period_fn(x, per):
        for i, blk in enumerate(cfg.pattern):
            x = _apply_block(periods[per][f"b{i}"], x, blk, cfg, positions,
                             moe_global)
        return x

    for per in range(cfg.num_periods):
        x = (checkpoint(period_fn, x, per, use_reentrant=False)
             if cfg.remat else period_fn(x, per))
    return L.norm(x, params.get("final_norm"), cfg.norm)

# --------------------------------------------------------------- loss ------


def lm_head_weight(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def lm_loss(params: Dict, hidden: torch.Tensor, targets: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Sequence-chunked cross entropy.  hidden: (B, S, D); targets: (B,
    S), -1 = masked.  The head product, optional ``logit_softcap``,
    logsumexp and the target logit run one ``cfg.loss_chunk`` of the
    sequence at a time (the tail padded with target -1), each chunk
    under a ``checkpoint`` so only its inputs are kept, never its (B,
    chunk, V) float32 logits.  Returns (token-mean loss, {"loss",
    "tokens"})."""
    b, s, _ = hidden.shape
    w = lm_head_weight(params, cfg).to(hidden.dtype)
    chunk = min(cfg.loss_chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad), value=-1)

    def chunk_loss(h, t):
        logits = (h @ w).float()                          # (B, c, V)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        tl = logits.gather(-1, t.clamp_min(0)[..., None].long())[..., 0]
        mask = (t >= 0).float()
        return ((lse - tl) * mask).sum(), mask.sum()

    loss_sum = torch.zeros((), device=hidden.device)
    count = torch.zeros((), device=hidden.device)
    for c0 in range(0, n_chunks * chunk, chunk):
        ls, m = checkpoint(chunk_loss, hidden[:, c0:c0 + chunk],
                           targets[:, c0:c0 + chunk], use_reentrant=False)
        loss_sum, count = loss_sum + ls, count + m
    loss = loss_sum / count.clamp_min(1)
    return loss, {"loss": loss, "tokens": count}


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig,
            moe_global: bool = False) -> Tuple[torch.Tensor, Dict]:
    hidden = forward(params, cfg, tokens=batch.get("tokens"),
                     embeds=batch.get("embeds"), moe_global=moe_global)
    return lm_loss(params, hidden, batch["targets"], cfg)

# ------------------------------------------------------------- decode ------


def attn_capacity(blk: BlockCfg, max_len: int) -> int:
    """Per-slot KV line count for one attention block: the sliding window
    bounds the live set, so windowed blocks cache a ring of that size."""
    return min(blk.window, max_len) if blk.window else max_len


def paged_layout(cfg: ModelConfig, max_len: int,
                 page_len: int) -> Dict[str, int]:
    """Page-table width per attention block, ``{bname: page_slots}``:
    ``ceil(capacity / page_len)`` entries cover one slot's capacity
    (window-bounded for sliding-window blocks)."""
    assert page_len > 0
    return {f"b{i}": -(-attn_capacity(blk, max_len) // page_len)
            for i, blk in enumerate(cfg.pattern) if blk.mixer == "attn"}


def paged_addressing(page_slots: int, page_len: int,
                     window: Optional[int]) -> Tuple[int, bool]:
    """(capacity_tokens, ring) of one paged pool: the write addressing
    the host allocator (``PagedKVCache.ensure``) and the device write
    (``_decode_attn``) share.  Ring pools write position p at
    ``p % capacity``, others clip to the last line."""
    cap = page_slots * page_len
    return cap, window is not None and cap >= window


def _cache_shapes(cfg: ModelConfig, blk: BlockCfg, batch: int,
                  max_len: int, page_len: int = 0,
                  pool_pages: Optional[int] = None) -> Dict[str, tuple]:
    p = cfg.num_periods
    hd = cfg.resolved_head_dim
    if blk.mixer == "mamba":
        return {"h": (p, batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                "conv": (p, batch, cfg.mamba_conv - 1, cfg.mamba_d_inner)}
    if blk.mixer == "rwkv":
        return {"s": (p, batch, cfg.rwkv_heads, cfg.rwkv_head_dim,
                      cfg.rwkv_head_dim),
                "x_prev": (p, batch, cfg.d_model)}
    if blk.mixer != "attn":
        raise ValueError(blk.mixer)
    if page_len > 0:
        # a pool of pages shared by all slots: axis 1 the physical page
        # (page 0 the trash page), axis 2 the line within it
        slots = -(-attn_capacity(blk, max_len) // page_len)
        n = (batch * slots + 1) if pool_pages is None else pool_pages
        return {"k": (p, n, page_len, cfg.num_kv_heads, hd),
                "v": (p, n, page_len, cfg.num_kv_heads, hd)}
    c = attn_capacity(blk, max_len)
    return {"k": (p, batch, c, cfg.num_kv_heads, hd),
            "v": (p, batch, c, cfg.num_kv_heads, hd)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str | None = None,
               page_len: int = 0,
               pool_pages: Optional[Dict[str, int]] = None) -> Dict:
    """Decode cache, zeroed, on ``device`` (``cuda`` unless named).
    Attention blocks hold ``{"k", "v"}``: contiguous (P, batch, capacity,
    Hkv, hd), or with ``page_len`` > 0 paged pools (P, pool_pages[bname],
    page_len, Hkv, hd) (default: the worst case ``batch × page_slots``
    pages plus the trash page).  Mamba blocks hold ``h`` (P, batch, dI, N)
    and ``conv`` (P, batch, K-1, dI), RWKV6 blocks ``s`` (P, batch, H, hd,
    hd) and ``x_prev`` (P, batch, D), and an RWKV channel-mix
    ``cm_x_prev`` (P, batch, D): slotted on either layout.  ``h`` and
    ``s`` are float32, every other leaf the compute type."""
    device = resolve_device(device)
    dt = DTYPES[cfg.compute_dtype]
    out = {}
    for i, blk in enumerate(cfg.pattern):
        shp = _cache_shapes(cfg, blk, batch, max_len, page_len,
                            (pool_pages or {}).get(f"b{i}"))
        if blk.ffn == "rwkv_cm":
            shp["cm_x_prev"] = (cfg.num_periods, batch, cfg.d_model)
        out[f"b{i}"] = {k: torch.zeros(
            s, dtype=torch.float32 if k in ("h", "s") else dt,
            device=device) for k, s in shp.items()}
    return out


def cache_structs(cfg: ModelConfig, batch: int, max_len: int,
                  page_len: int = 0,
                  pool_pages: Optional[Dict[str, int]] = None) -> Dict:
    """``init_cache``'s tree as meta tensors (no storage): the reference's
    ``cache_structs``, bf16 KV (the compute type) and float32 recurrent
    state."""
    return init_cache(cfg, batch, max_len, device="meta",
                      page_len=page_len, pool_pages=pool_pages)


def _decode_attn(p: Dict, x: torch.Tensor, cache: Dict, cfg: ModelConfig,
                 blk: BlockCfg, pos: torch.Tensor,
                 packed: Optional[Dict] = None,
                 impl: Optional[str] = None,
                 page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention sub-block of one decode step.  ``cache`` holds this
    period's (B, C, Hkv, hd) views — or, with ``page_table`` ((B,
    page_slots) int64 physical page ids, 0 the trash page), its (NP, L,
    Hkv, hd) page pools; the new K/V line is written into them in place
    and the paged attention reads the slot's pages gathered into one
    contiguous view.  ``packed`` maps wq/wk/wv/wo to ``BitmapWeight``s."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    pk = packed or {}
    xn = L.norm(x, p.get("norm"), cfg.norm)
    q = L.matmul_or_bitmap(xn, p["wq"], pk.get("wq"), impl).reshape(
        b, 1, h, hd)
    k = L.matmul_or_bitmap(xn, p["wk"], pk.get("wk"), impl).reshape(
        b, 1, kv, hd)
    v = L.matmul_or_bitmap(xn, p["wv"], pk.get("wv"), impl).reshape(
        b, 1, kv, hd)
    if cfg.qk_norm:
        q = L.norm(q, p["q_norm"], "rmsnorm")
        k = L.norm(k, p["k_norm"], "rmsnorm")
    posv = pos.expand(b) if pos.dim() == 0 else pos
    q = L.rope(q, posv[:, None], cfg.rope_theta)
    k = L.rope(k, posv[:, None], cfg.rope_theta)
    if page_table is not None:
        cap, ring = paged_addressing(page_table.shape[1],
                                     cache["k"].shape[1], blk.window)
        slot = (posv % cap) if ring else posv.clamp(0, cap - 1)
        L.paged_kv_update(cache["k"], cache["v"], k, v, page_table, slot)
        o = L.decode_attention(q, L.paged_gather(cache["k"], page_table),
                               L.paged_gather(cache["v"], page_table), pos,
                               window=blk.window, ring=ring, impl=impl)
        return L.matmul_or_bitmap(o.reshape(b, 1, h * hd), p["wo"],
                                  pk.get("wo"), impl)
    c = cache["k"].shape[1]
    ring = blk.window is not None and c == blk.window
    if pos.dim() == 0:
        # one shared position: the reference's dynamic_update_slice,
        # whose start index is clamped into the cache
        slot = (pos % c) if ring else pos.clamp(0, c - 1)
        idx = slot.reshape(1).to(torch.int64)
        cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
    else:
        slot = (posv % c) if ring else posv.clamp(0, c - 1)
        L.slot_kv_update(cache["k"], cache["v"], k, v, slot)
    o = L.decode_attention(q, cache["k"], cache["v"], pos,
                           window=blk.window, ring=ring, impl=impl)
    return L.matmul_or_bitmap(o.reshape(b, 1, h * hd), p["wo"],
                              pk.get("wo"), impl)


def _period(tree: Optional[Dict], p: int):
    """Period ``p`` of a period-stacked tree (tensor or BitmapWeight
    leaves; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _period(v, p) for k, v in tree.items()}
    return tree.period(p) if isinstance(tree, BitmapWeight) else tree[p]


def decode_hidden(params: Dict, cache: Dict, cfg: ModelConfig,
                  tokens: Optional[torch.Tensor], pos: torch.Tensor,
                  embeds: Optional[torch.Tensor] = None,
                  packed: Optional[Dict] = None,
                  impl: Optional[str] = None,
                  page_tables: Optional[Dict] = None,
                  moe_global: bool = False
                  ) -> Tuple[torch.Tensor, Dict]:
    """One decode step up to (and including) the final norm.

    tokens: (B, 1); pos: scalar shared position or a (B,) vector of
    per-slot positions.  Returns (hidden (B, 1, D), cache) — the cache is
    the one passed in, updated in place.  ``packed`` mirrors
    ``params["blocks"]`` with period-stacked ``BitmapWeight`` leaves (None
    where a tensor is served dense).  ``page_tables`` (``{bname: (B,
    page_slots)}`` int64 on the cache's device) switches attention blocks
    onto the paged pools; one table serves every period of its block.
    ``moe_global`` (baseline mode): the MoE blocks rank the B tokens
    together (``L._moe_ffn_global``).
    """
    x = embed_inputs(params, cfg, tokens, embeds)
    for per in range(cfg.num_periods):
        for i, blk in enumerate(cfg.pattern):
            bname = f"b{i}"
            bp = _period(params["blocks"][bname], per)
            pc = {k: v[per] for k, v in cache[bname].items()}
            pw = _period((packed or {}).get(bname), per) or {}
            if blk.mixer == "attn":
                x = x + _decode_attn(bp["attn"], x, pc, cfg, blk, pos,
                                     packed=pw.get("attn"), impl=impl,
                                     page_table=(page_tables or {}).get(
                                         bname))
            else:
                mix = ssm.mamba_decode if blk.mixer == "mamba" \
                    else ssm.rwkv_decode
                xn = L.norm(x, bp[blk.mixer].get("norm"), cfg.norm)
                o, st = mix(bp[blk.mixer], xn, pc, cfg,
                            packed=pw.get(blk.mixer), impl=impl)
                x = x + o
                _write_state(pc, st)
            x = _ffn(bp, pw, x, cfg, blk, impl, pc, moe_global)
    return L.norm(x, params.get("final_norm"), cfg.norm), cache


def _write_state(pc: Dict[str, torch.Tensor],
                 new: Dict[str, torch.Tensor]) -> None:
    """Write a recurrent block's new state into its cache views, in
    place.  Called once the step has read all of the old state: the new
    tensors never alias the views they overwrite."""
    for k, t in new.items():
        pc[k].copy_(t)


def _ffn(bp: Dict, pw: Dict, x: torch.Tensor, cfg: ModelConfig,
         blk: BlockCfg, impl: Optional[str],
         pc: Optional[Dict[str, torch.Tensor]] = None,
         moe_global: bool = False) -> torch.Tensor:
    """The residual FFN sub-block of one layer: x (B, S, D) -> x + ffn.
    MoE dispatches each of the B·S tokens as its own row (x folded to
    (B·S, 1, D)), so a prefill chunk routes, and drops at capacity, token
    for token as the decode steps would (``moe_global``: the B·S tokens
    ranked together, as the reference's baseline mode does).  The RWKV
    channel-mix (decode only) reads its ``cm_x_prev`` from the period's
    cache views ``pc`` and writes the normed input back there."""
    if blk.ffn == "mlp":
        xn = L.norm(x, bp["mlp"].get("norm"), cfg.norm)
        return x + L.mlp(bp["mlp"], xn, cfg, packed=pw.get("mlp"),
                         impl=impl)
    if blk.ffn == "moe":
        b, s, d = x.shape
        xn = L.norm(x, bp["moe"].get("norm"), cfg.norm)
        mo = L.moe_ffn(bp["moe"], xn.reshape(b * s, 1, d), cfg,
                       packed=pw.get("moe"), impl=impl,
                       global_dispatch=moe_global)
        return x + mo.reshape(b, s, d)
    if blk.ffn == "rwkv_cm":
        xn = L.norm(x, bp["rwkv_cm"].get("norm"), cfg.norm)
        out = x + ssm.rwkv_channel_mix(bp["rwkv_cm"], xn,
                                       pc["cm_x_prev"][:, None],
                                       packed=pw.get("rwkv_cm"), impl=impl)
        _write_state(pc, {"cm_x_prev": xn[:, 0]})
        return out
    if blk.ffn != "none":
        raise ValueError(blk.ffn)
    return x


def _prefill_attn(p: Dict, x: torch.Tensor, cache: Dict, cfg: ModelConfig,
                  blk: BlockCfg, pos: torch.Tensor, lens: torch.Tensor,
                  packed: Optional[Dict] = None,
                  impl: Optional[str] = None,
                  page_table: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Chunked-prefill attention: C tokens per slot in one call.  x: (B,
    C, D); pos: (B,) chunk start positions; lens: (B,) valid tokens per
    slot (lanes past it are padding: they write nothing into the
    contiguous cache, the trash page of a paged one).  ``page_table``
    switches to the paged pools, as in ``_decode_attn``.

    The q/k/v/o projections run batched over the chunk (M = B·C rows);
    the cache write and the attention scan the chunk one token at a
    time — token t's K/V line is written, then token t attends — exactly
    the state a decode step sees at that position, so chunked prefill is
    bit-identical to walking the prompt through decode steps.
    """
    b, c_chunk, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    pk = packed or {}
    xn = L.norm(x, p.get("norm"), cfg.norm)
    q = L.matmul_or_bitmap(xn, p["wq"], pk.get("wq"), impl).reshape(
        b, c_chunk, h, hd)
    k = L.matmul_or_bitmap(xn, p["wk"], pk.get("wk"), impl).reshape(
        b, c_chunk, kv, hd)
    v = L.matmul_or_bitmap(xn, p["wv"], pk.get("wv"), impl).reshape(
        b, c_chunk, kv, hd)
    if cfg.qk_norm:
        q = L.norm(q, p["q_norm"], "rmsnorm")
        k = L.norm(k, p["k_norm"], "rmsnorm")
    posb = pos[:, None] + torch.arange(c_chunk, device=x.device)[None, :]
    q = L.rope(q, posb, cfg.rope_theta)
    k = L.rope(k, posb, cfg.rope_theta)
    if page_table is not None:
        cap, ring = paged_addressing(page_table.shape[1],
                                     cache["k"].shape[1], blk.window)
    else:
        cap = cache["k"].shape[1]
        ring = blk.window is not None and cap == blk.window
    outs = []
    for t in range(c_chunk):
        pos_t = pos + t
        slot = (pos_t % cap) if ring else pos_t.clamp(0, cap - 1)
        if page_table is not None:
            L.paged_kv_update(cache["k"], cache["v"], k[:, t:t + 1],
                              v[:, t:t + 1], page_table, slot,
                              valid=t < lens)
            k_att = L.paged_gather(cache["k"], page_table)
            v_att = L.paged_gather(cache["v"], page_table)
        else:
            L.slot_kv_update(cache["k"], cache["v"], k[:, t:t + 1],
                             v[:, t:t + 1], slot, valid=t < lens)
            k_att, v_att = cache["k"], cache["v"]
        outs.append(L.decode_attention(q[:, t:t + 1], k_att, v_att, pos_t,
                                       window=blk.window, ring=ring,
                                       impl=impl))
    o = torch.cat(outs, dim=1)                             # (B, C, Hq, hd)
    return L.matmul_or_bitmap(o.reshape(b, c_chunk, h * hd), p["wo"],
                              pk.get("wo"), impl)


def prefill_hidden(params: Dict, cache: Dict, cfg: ModelConfig,
                   tokens: Optional[torch.Tensor], pos: torch.Tensor,
                   lens: torch.Tensor,
                   embeds: Optional[torch.Tensor] = None,
                   packed: Optional[Dict] = None,
                   impl: Optional[str] = None,
                   page_tables: Optional[Dict] = None,
                   moe_global: bool = False
                   ) -> Tuple[torch.Tensor, Dict]:
    """One chunked-prefill call: C prompt tokens per slot in one pass.

    tokens: (B, C) (or embeds (B, C, D)); pos: (B,) chunk start
    positions; lens: (B,) valid tokens per slot (0: the slot sits the
    call out, its lane writes nothing).  Returns (hidden (B, C, D) after
    the final norm, cache) — the cache passed in, its C lines per slot
    written in place.  Projections run at M = B·C; MoE FFNs fold the
    chunk into the batch so expert capacity matches the decode path.
    ``page_tables`` and ``moe_global`` as in ``decode_hidden``.
    Recurrent mixers (mamba/rwkv) have no chunked path and raise.
    """
    x = embed_inputs(params, cfg, tokens, embeds)
    for per in range(cfg.num_periods):
        for i, blk in enumerate(cfg.pattern):
            bname = f"b{i}"
            if blk.mixer != "attn" or blk.ffn == "rwkv_cm":
                raise NotImplementedError(
                    f"chunked prefill has no {blk.mixer}/{blk.ffn} path")
            bp = _period(params["blocks"][bname], per)
            pc = {k: v[per] for k, v in cache[bname].items()}
            pw = _period((packed or {}).get(bname), per) or {}
            x = x + _prefill_attn(bp["attn"], x, pc, cfg, blk, pos, lens,
                                  packed=pw.get("attn"), impl=impl,
                                  page_table=(page_tables or {}).get(bname))
            x = _ffn(bp, pw, x, cfg, blk, impl, moe_global=moe_global)
    return L.norm(x, params.get("final_norm"), cfg.norm), cache


def head_logits(params: Dict, cfg: ModelConfig, hidden: torch.Tensor,
                lm_weight=None, lm_impl: Optional[str] = None
                ) -> torch.Tensor:
    """LM head over (B, D) hidden states -> (B, V) float32 logits.

    ``lm_weight`` (a ``BitmapWeight``) puts the head product on the
    bitmap-compressed ``kernels/ops.bitmap_spmm`` path; None takes the
    params' head."""
    if lm_weight is None:
        logits = (hidden @ lm_head_weight(params, cfg).to(hidden.dtype)
                  ).float()
    else:
        from repro_torch.kernels import ops
        logits = ops.bitmap_spmm(hidden, lm_weight, impl=lm_impl).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def decode_step(params: Dict, cache: Dict, cfg: ModelConfig,
                tokens: Optional[torch.Tensor], pos: torch.Tensor,
                embeds: Optional[torch.Tensor] = None, lm_weight=None,
                packed: Optional[Dict] = None,
                lm_impl: Optional[str] = None,
                page_tables: Optional[Dict] = None,
                moe_global: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step + LM head: (logits (B, V), cache); ``page_tables``
    routes the KV cache through the paged pools and ``moe_global`` the
    MoE blocks through the global dispatch (``decode_hidden``)."""
    x, cache = decode_hidden(params, cache, cfg, tokens, pos,
                             embeds=embeds, packed=packed, impl=lm_impl,
                             page_tables=page_tables, moe_global=moe_global)
    return head_logits(params, cfg, x[:, 0], lm_weight, lm_impl), cache

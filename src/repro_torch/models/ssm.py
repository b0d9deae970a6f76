"""State-space mixers: Mamba (jamba) and RWKV6, full-sequence and decode.

Port of ``repro/models/ssm.py``.  The single-step functions
(``mamba_decode``, ``rwkv_decode`` and the RWKV channel-mix at decode)
serve: every projection goes through ``layers.matmul_or_bitmap``
(``packed`` maps its name to a ``BitmapWeight``, so on the card it is
K1), and RWKV6's 5-way lerp stack ``mix_B`` through
``ops.bitmap_spmm_grouped`` (K1g).  The full-sequence ``mamba_mix`` and
``rwkv_mix`` are the training path: dense, differentiable, and written
without in-place writes.  The recurrences are elementwise and small
contractions, plain torch ops as the reference's are plain ``jnp``.
The cast order is the reference's: the states ``h`` and ``s`` and the
recurrences in float32, activations in the compute type.

Each decode function returns its new state as new tensors and leaves
the one it was given as it was; ``model.decode_hidden`` writes the new
state into the cache in place once every read of the old one is done.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import group_norm_heads, matmul_or_bitmap


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere
    (``F.softplus`` turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))

# ---------------------------------------------------------------- Mamba ----


def _ssm_chunk(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + bx_t over axis 1.  a, bx: (B, C, dI, N); h0:
    (B, dI, N).  Returns (h_all, h_last).

    An inclusive scan of the affine maps (a, b) by doubling
    (Hillis-Steele): after the step with offset o each position holds the
    composition of the (up to) 2·o maps ending there.  The reference's
    ``associative_scan`` composes the same maps in another tree: equal in
    real arithmetic, float32 rounding apart."""
    c = a.shape[1]
    off = 1
    while off < c:
        a_prev = F.pad(a[:, :-off], (0, 0, 0, 0, off, 0), value=1.0)
        b_prev = F.pad(bx[:, :-off], (0, 0, 0, 0, off, 0))
        a, bx = a_prev * a, b_prev * a + bx
        off *= 2
    h = a * h0[:, None] + bx
    return h, h[:, -1]


def mamba_mix(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              chunk: int = 256) -> torch.Tensor:
    """Selective SSM (Mamba-1) forward over a sequence.  x: (B, S, D) ->
    (B, S, D).  The depthwise causal conv, the selective parameters and
    a chunked scan of the float32 state, as the reference."""
    b, s, _ = x.shape
    n = cfg.mamba_d_state
    dtr = cfg.mamba_dt_rank
    dt_ = x.dtype

    xs, z = (x @ params["in_proj"].to(dt_)).chunk(2, dim=-1)  # (B, S, dI)

    conv_w = params["conv_w"].to(dt_)                    # (dI, K)
    kk = conv_w.shape[-1]
    pad = F.pad(xs, (0, 0, kk - 1, 0))
    xs = sum(pad[:, i:i + s] * conv_w[:, i] for i in range(kk))
    xs = F.silu(xs + params["conv_b"].to(dt_))

    dbc = xs @ params["x_proj"].to(dt_)                  # (B, S, dtr + 2N)
    dt, bmat, cmat = dbc.split([dtr, n, n], dim=-1)
    dt = softplus(dt @ params["dt_proj"].to(dt_) + params["dt_bias"].to(dt_))
    a = -torch.exp(params["A_log"].float())              # (dI, N)

    dt32 = dt.float()
    da = torch.exp(dt32[..., None] * a)                  # (B, S, dI, N)
    dbx = dt32[..., None] * bmat.float()[:, :, None, :] * xs.float()[..., None]

    h = torch.zeros((b, da.shape[2], n), device=x.device)
    hs = []
    for c0 in range(0, s, chunk):
        h_all, h = _ssm_chunk(da[:, c0:c0 + chunk], dbx[:, c0:c0 + chunk], h)
        hs.append(h_all)
    h_seq = torch.cat(hs, dim=1)                         # (B, S, dI, N)

    y = torch.einsum("bsdn,bsn->bsd", h_seq, cmat.float())
    y = y.to(dt_) + xs * params["D"].to(dt_)
    y = y * F.silu(z)
    return y @ params["out_proj"].to(dt_)


def mamba_decode(params: Dict, x: torch.Tensor, state: Dict,
                 cfg: ModelConfig, packed: Optional[Dict] = None,
                 impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token Mamba step.  x: (B, 1, D); state: {"h": (B, dI, N)
    float32, "conv": (B, K-1, dI)}.  ``packed`` maps in_proj / x_proj /
    dt_proj / out_proj to ``BitmapWeight``s.  Returns (out (B, 1, D),
    {"h", "conv"})."""
    pk = packed or {}
    n = cfg.mamba_d_state
    dtr = cfg.mamba_dt_rank
    dt_ = x.dtype

    xz = matmul_or_bitmap(x[:, 0], params["in_proj"], pk.get("in_proj"),
                          impl)
    xs, z = xz.chunk(2, dim=-1)                          # (B, dI)

    conv_w = params["conv_w"].to(dt_)                    # (dI, K)
    hist = torch.cat([state["conv"], xs[:, None]], 1)   # (B, K, dI)
    # the depthwise conv in the compute type, rounded once
    xs_c = torch.einsum("bkd,dk->bd", hist.float(), conv_w.float()).to(dt_)
    xs_c = F.silu(xs_c + params["conv_b"].to(dt_))

    dbc = matmul_or_bitmap(xs_c, params["x_proj"], pk.get("x_proj"), impl)
    dt, bmat, cmat = dbc.split([dtr, n, n], dim=-1)
    dt = softplus(matmul_or_bitmap(dt, params["dt_proj"], pk.get("dt_proj"),
                                   impl) + params["dt_bias"].to(dt_))
    a = -torch.exp(params["A_log"].float())               # (dI, N)
    dt32 = dt.float()
    da = torch.exp(dt32[..., None] * a)                  # (B, dI, N)
    dbx = (dt32[..., None] * bmat.float()[:, None, :]
           * xs_c.float()[..., None])
    h = da * state["h"] + dbx
    y = torch.einsum("bdn,bn->bd", h, cmat.float()).to(dt_)
    y = y + xs_c * params["D"].to(dt_)
    y = y * F.silu(z)
    out = matmul_or_bitmap(y, params["out_proj"], pk.get("out_proj"),
                           impl)[:, None]
    return out, {"h": h, "conv": hist[:, 1:]}

# ---------------------------------------------------------------- RWKV6 ----


def _rwkv_tokens(params: Dict, x: torch.Tensor, x_prev: torch.Tensor,
                 packed: Optional[Dict] = None, impl: Optional[str] = None):
    """r, k, v, w, g of the RWKV6 time-mix.  x, x_prev: (B, S, D).  The
    LoRA lerp: ``mix_A`` through K1, then the 5 (rank, D) lerp products
    of ``mix_B`` as one grouped call (K1g), or the dense einsum where it
    fell back or was quarantined.  The data-dependent decay is
    ``w0 + tanh(x @ decay_A) @ decay_B`` with the second product's X
    (and so its output) in float32."""
    pk = packed or {}
    dt_ = x.dtype
    diff = x_prev - x
    lora = torch.tanh(matmul_or_bitmap(x, params["mix_A"], pk.get("mix_A"),
                                       impl))           # (B, S, 5·r)
    lora = lora.reshape(*x.shape[:-1], 5, -1)
    if pk.get("mix_B") is None:
        dyn = torch.einsum("bsfr,frd->bsfd", lora,
                           params["mix_B"].to(dt_))
    else:
        from repro_torch.kernels import ops
        b, s, f, r = lora.shape
        lx = lora.permute(2, 0, 1, 3).reshape(f, b * s, r)
        dyn = ops.bitmap_spmm_grouped(lx, pk["mix_B"], impl=impl).reshape(
            f, b, s, -1).permute(1, 2, 0, 3)
    mix = params["mix_mu"].to(dt_) + dyn                 # (B, S, 5, D)
    xr, xk, xv, xw, xg = [x + diff * mix[..., i, :] for i in range(5)]

    r = matmul_or_bitmap(xr, params["w_r"], pk.get("w_r"), impl)
    k = matmul_or_bitmap(xk, params["w_k"], pk.get("w_k"), impl)
    v = matmul_or_bitmap(xv, params["w_v"], pk.get("w_v"), impl)
    g = F.silu(matmul_or_bitmap(xg, params["w_g"], pk.get("w_g"), impl))
    lo = torch.tanh(matmul_or_bitmap(xw, params["decay_A"],
                                     pk.get("decay_A"), impl)).float()
    ww = params["w0"].float() + matmul_or_bitmap(
        lo, params["decay_B"], pk.get("decay_B"), impl)
    w = torch.exp(-torch.exp(ww))                        # (B, S, D) in (0, 1)
    return r, k, v, w, g


def shift_right(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) shifted one token later along S, zeros first: each
    token's predecessor (the token shift)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv_mix(params: Dict, x: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    """RWKV6 time-mix over a sequence.  x: (B, S, D) -> (B, S, D).  The
    (B, H, hd, hd) float32 state is carried token by token, as in the
    reference's inner scan; its outer chunking only pads past the last
    token and changes no output, so it is not repeated here."""
    b, s, _ = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    r, k, v, w, g = _rwkv_tokens(params, x, shift_right(x))
    r_, k_, v_, w_ = (t.reshape(b, s, h, hd).float() for t in (r, k, v, w))
    u = params["u"].float()[None, :, :, None]            # (1, H, hd, 1)
    st = torch.zeros((b, h, hd, hd), device=x.device)
    outs = []
    for t in range(s):
        kv = k_[:, t, :, :, None] * v_[:, t, :, None, :]  # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_[:, t], st + u * kv))
        st = w_[:, t, :, :, None] * st + kv
    out = torch.stack(outs, dim=1).reshape(b, s, h * hd)
    out = group_norm_heads(out.to(x.dtype), params["gn_scale"], h) * g
    return out @ params["w_o"].to(x.dtype)


def rwkv_decode(params: Dict, x: torch.Tensor, state: Dict,
                cfg: ModelConfig, packed: Optional[Dict] = None,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token RWKV6 time-mix step.  x: (B, 1, D) (the normed input);
    state: {"s": (B, H, hd, hd) float32, "x_prev": (B, D)}.  Returns
    (out (B, 1, D), {"s", "x_prev"})."""
    b = x.shape[0]
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    r, k, v, w, g = _rwkv_tokens(params, x, state["x_prev"][:, None],
                                 packed=packed, impl=impl)
    rt, kt, vt, wt = (t[:, 0].reshape(b, h, hd).float()
                      for t in (r, k, v, w))
    u = params["u"].float()
    s = state["s"]
    kv = kt[..., :, None] * vt[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rt, s + u[..., None] * kv)
    new_s = wt[..., :, None] * s + kv
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    out = group_norm_heads(out, params["gn_scale"], h) * g
    return (matmul_or_bitmap(out, params["w_o"], (packed or {}).get("w_o"),
                             impl),
            {"s": new_s, "x_prev": x[:, 0]})


def rwkv_channel_mix(params: Dict, x: torch.Tensor,
                     x_prev: Optional[torch.Tensor] = None,
                     packed: Optional[Dict] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """RWKV channel-mix (squared-relu): x, x_prev (B, S, D) ->
    ``sigmoid(xr @ cm_r) * (relu(xk @ cm_k)² @ cm_v)``.  At decode
    ``x_prev`` is the cached previous token (S = 1); over a sequence it
    defaults to x's token shift.  ``packed`` maps cm_k / cm_v / cm_r to
    ``BitmapWeight``s."""
    pk = packed or {}
    dt_ = x.dtype
    if x_prev is None:
        x_prev = shift_right(x)
    mu = params["cm_mu"].to(dt_)                         # (2, D)
    diff = x_prev - x
    xk = x + diff * mu[0]
    xr = x + diff * mu[1]
    k = torch.square(F.relu(matmul_or_bitmap(xk, params["cm_k"],
                                             pk.get("cm_k"), impl)))
    return torch.sigmoid(
        matmul_or_bitmap(xr, params["cm_r"], pk.get("cm_r"), impl)
    ) * matmul_or_bitmap(k, params["cm_v"], pk.get("cm_v"), impl)

"""Plain float32 decoder LM: the reference for the served configurations.

The equations, for a configuration file's widths: token embedding;
per layer a pre-norm attention block (no biases; rotary embedding on
the two halves of each head, base ``rope_theta``; causal softmax
attention, grouped query heads sharing their key/value head) and a
pre-norm feed-forward block, either SwiGLU (``silu(x·Wg) ⊙ (x·Wu) ·
Wd``) or a mixture of SwiGLU experts (softmax router, the top k experts
by probability, ties to the lower index, their probabilities
renormalised to sum to one, every token served by all k); a final norm;
the head tied to the embedding.  The norm is the non-parametric layer
norm (eps 1e-5) or RMS norm with a (1 + scale) gain (eps 1e-6), as the
file says.  Everything in float32 with TF32 off; no cache, no batching,
no kernel.

``quant="fp8"`` computes the same in the precision below the served
one, for the control: both operands of every weight product, and the
keys, values and queries of attention, rounded to float8 e4m3 with one
scale per row of activations, per output column of a weight, per
head vector of attention.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from reference import prune

_FP8_MAX = 448.0

# the products the program streams as bitmaps, one weight per layer
PACKED_2D = {("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"),
             ("moe", "router")}
PACKED_GROUPED = {("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down")}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to the format's largest)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    if quant == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def norm(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "ln_nonparam":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5)
    if kind == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    raise ValueError(kind)


def rmsnorm_gain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D): the halves of each head rotated as pairs."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def leaf_shapes(model: Dict) -> List[Tuple[Tuple[str, ...], tuple]]:
    """(path, shape) of every leaf of the port's parameter tree (block
    leaves stacked over the layers), in the order the weights are drawn."""
    d, layers = model["d_model"], model["num_layers"]
    h, kv = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // h
    f = model["d_ff"]
    out = [(("embed",), (model["vocab_size"], d)),
           (("final_norm",), (d,)),
           (("blocks", "b0", "attn", "norm"), (layers, d)),
           (("blocks", "b0", "attn", "wq"), (layers, d, h * hd)),
           (("blocks", "b0", "attn", "wk"), (layers, d, kv * hd)),
           (("blocks", "b0", "attn", "wv"), (layers, d, kv * hd)),
           (("blocks", "b0", "attn", "wo"), (layers, h * hd, d))]
    if model["ffn"] == "mlp":
        out += [(("blocks", "b0", "mlp", "norm"), (layers, d)),
                (("blocks", "b0", "mlp", "w_gate"), (layers, d, f)),
                (("blocks", "b0", "mlp", "w_up"), (layers, d, f)),
                (("blocks", "b0", "mlp", "w_down"), (layers, f, d))]
    elif model["ffn"] == "moe":
        e = model["num_experts"]
        out += [(("blocks", "b0", "moe", "norm"), (layers, d)),
                (("blocks", "b0", "moe", "router"), (layers, d, e)),
                (("blocks", "b0", "moe", "w_gate"), (layers, e, d, f)),
                (("blocks", "b0", "moe", "w_up"), (layers, e, d, f)),
                (("blocks", "b0", "moe", "w_down"), (layers, e, f, d))]
    else:
        raise ValueError(f"ffn {model['ffn']!r}")
    return out


def prepare(params: Dict, model: Dict, head: str = "serve") -> Dict:
    """Prune ``params`` (the dense tree made from the seed) in place by
    the configuration's rule and return the reference's weights:
    {"params", "head" (D, V), "kept" {path: kept values}}.  ``head``:
    "serve" prunes the tied head per tensor to ``head_sparsity``;
    "tied" uses the embedding as it is (training's head)."""
    leaves = list(_leaves(params))
    kept = (prune.global_prune_(leaves, model["sparsity"])
            if model["sparsity"] > 0 else {})
    w = params["embed"].t()
    if head == "serve" and model["head_sparsity"] > 0:
        w = prune.per_tensor_prune(w.contiguous(), model["head_sparsity"])
    kept[("head",)] = int(torch.count_nonzero(w))
    return {"params": params, "head": w, "kept": kept}


def kept_counts(ref: Dict, model: Dict) -> Dict:
    """Kept values of every product the program streams as a bitmap,
    keyed by (groups, K, N) (one entry per layer), and the kept weights
    one token meets ("active"), the head included."""
    shapes: Dict[Tuple[int, int, int], List[int]] = {}
    active = 0.0
    blocks = ref["params"]["blocks"]["b0"]
    for comp, tensors in blocks.items():
        for name, leaf in tensors.items():
            key = (comp, name)
            if key in PACKED_GROUPED:
                g, k, n = leaf.shape[1:]
                per = [int(torch.count_nonzero(leaf[p]))
                       for p in range(leaf.shape[0])]
                shapes.setdefault((g, k, n), []).extend(per)
                active += sum(per) * model["top_k"] / model["num_experts"]
            elif key in PACKED_2D:
                k, n = leaf.shape[1:]
                per = [int(torch.count_nonzero(leaf[p]))
                       for p in range(leaf.shape[0])]
                shapes.setdefault((1, k, n), []).extend(per)
                active += sum(per)
    head = ref["head"]
    kept_head = int(torch.count_nonzero(head))
    if model["head_sparsity"] > 0:
        shapes.setdefault((1, *head.shape), []).append(kept_head)
    active += kept_head
    return {"shapes": shapes, "active": active}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _norm_block(x, p, model):
    y = norm(x, model["norm"])
    if model["norm"] == "rmsnorm":
        y = rmsnorm_gain(y, p)
    return y


def attention(x, p: Dict, layer: int, model: Dict, pos: torch.Tensor,
              quant: Optional[str]) -> torch.Tensor:
    s, d = x.shape
    h, kv = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // h
    xn = _norm_block(x, p["norm"][layer], model)
    q = matmul(xn, p["wq"][layer], quant).reshape(s, h, hd)
    k = matmul(xn, p["wk"][layer], quant).reshape(s, kv, hd)
    v = matmul(xn, p["wv"][layer], quant).reshape(s, kv, hd)
    q = rope(q, pos, model["rope_theta"])
    k = rope(k, pos, model["rope_theta"])
    if quant == "fp8":
        q, k, v = fp8(q, -1), fp8(k, -1), fp8(v, -1)
    g = h // kv
    qh = q.reshape(s, kv, g, hd).permute(1, 2, 0, 3)          # kv g s hd
    kh = k.permute(1, 0, 2)[:, None]                          # kv 1 s hd
    vh = v.permute(1, 0, 2)[:, None]
    scores = (qh @ kh.transpose(-1, -2)) * hd ** -0.5         # kv g s s
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = torch.softmax(scores, dim=-1) @ vh                    # kv g s hd
    o = o.permute(2, 0, 1, 3).reshape(s, h * hd)
    return matmul(o, p["wo"][layer], quant)


def swiglu(x, wg, wu, wd, quant):
    return matmul(torch.nn.functional.silu(matmul(x, wg, quant))
                  * matmul(x, wu, quant), wd, quant)


def feed_forward(x, p: Dict, layer: int, model: Dict,
                 quant: Optional[str]) -> torch.Tensor:
    xn = _norm_block(x, p["norm"][layer], model)
    if model["ffn"] == "mlp":
        return swiglu(xn, p["w_gate"][layer], p["w_up"][layer],
                      p["w_down"][layer], quant)
    probs = torch.softmax(matmul(xn, p["router"][layer], quant), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = top.values[:, :model["top_k"]]
    idx = top.indices[:, :model["top_k"]]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(xn)
    for e in range(model["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(xn[tok], p["w_gate"][layer][e], p["w_up"][layer][e],
                   p["w_down"][layer][e], quant)
        out.index_add_(0, tok, y * gate[tok, slot][:, None])
    return out


def hidden(ref: Dict, model: Dict, tokens: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """Final-norm hidden states (S, D) of one sequence."""
    p = ref["params"]
    blocks = p["blocks"]["b0"]
    ffn = blocks["mlp" if model["ffn"] == "mlp" else "moe"]
    x = p["embed"][tokens]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    for layer in range(model["num_layers"]):
        x = x + attention(x, blocks["attn"], layer, model, pos, quant)
        x = x + feed_forward(x, ffn, layer, model, quant)
    y = norm(x, model["norm"])
    if model["norm"] == "rmsnorm":
        y = rmsnorm_gain(y, p["final_norm"])
    return y


def logits_at(ref: Dict, model: Dict, tokens: Sequence[int],
              at: Sequence[int], device, quant: Optional[str] = None
              ) -> torch.Tensor:
    """Float32 logits (len(at), V) at positions ``at`` of the sequence
    ``tokens`` (the logits predicting the token after each)."""
    with torch.no_grad():
        t = torch.tensor(list(tokens), dtype=torch.int64, device=device)
        h = hidden(ref, model, t, quant)[torch.tensor(list(at),
                                                      device=device)]
        return matmul(h, ref["head"], quant)

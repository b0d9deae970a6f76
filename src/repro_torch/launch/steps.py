"""Step-function builders: train, eval, prefill logits, serve (decode)
and the chunked-prefill call.

Port of ``repro/launch/steps.py`` on one device.  The train step is
forward, backward through ``torch.autograd.grad`` and an in-place AdamW
update, with masked-gradient sparse training and gradient accumulation.
The serve step is greedy argmax by default; slots with a temperature
above 0 sample from ``softmax(logits / T)``, optionally truncated to
their own top-k.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, forward, lm_head_weight,
                                      loss_fn, prefill_hidden)
from repro_torch.sparse.pruning import tree_items, tree_map
from repro_torch.train import optimizer as opt_lib


def loss_and_grads(params: Dict, batch: Dict, cfg: ModelConfig):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; the grads a
    dict shaped as ``params``, in the params' dtype, zero for leaves the
    loss does not read (as ``jax.grad`` gives)."""
    leaves = tree_items(params)
    with torch.enable_grad():
        live = {p: l.detach().requires_grad_(True) for p, l in leaves}
        loss, metrics = loss_fn(tree_map(lambda p, _: live[p], params),
                                batch, cfg)
        # a leaf the arch never reads (olmo's norm scales) gets zeros
        grads = torch.autograd.grad(loss, list(live.values()),
                                    materialize_grads=True)
    flat = dict(zip(live, grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda p, _: flat[p], params)


def build_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig,
                     prune_masks: Optional[Dict] = None,
                     accum_steps: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    update written into ``params`` and ``opt_state`` in place.

    ``prune_masks`` (a tree shaped as params, bool or 0/1) multiplies the
    gradients before the update and the parameters after it, so pruned
    weights stay exactly zero (masked-gradient sparse training).
    ``accum_steps`` > 1 splits the batch into that many equal
    microbatches (consecutive rows), sums their float32 gradients and
    divides by the count; the loss is the token-weighted mean.  Metrics:
    ``loss``, ``tokens``, ``grad_norm``, ``lr`` (tensors on the device).
    """

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            _, metrics, grads = loss_and_grads(params, batch, cfg)
        else:
            gsum, lsum, csum = {}, 0, 0
            for i in range(accum_steps):
                micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                _, m, g = loss_and_grads(params, micro, cfg)
                for p, t in tree_items(g):
                    gsum[p] = t.float() + gsum.get(p, 0)
                lsum = lsum + m["loss"] * m["tokens"]
                csum = csum + m["tokens"]
            grads = tree_map(lambda p, _: gsum[p] / accum_steps, params)
            metrics = {"loss": lsum / csum.clamp_min(1), "tokens": csum}
        if prune_masks is not None:
            masks = dict(tree_items(prune_masks))
            with torch.no_grad():                # the grads are this step's
                for p, g in tree_items(grads):
                    g.mul_(masks[p])
        params, opt_state, opt_metrics = opt_lib.update(params, grads,
                                                        opt_state, opt_cfg)
        if prune_masks is not None:
            with torch.no_grad():
                for p, leaf in tree_items(params):
                    leaf.mul_(masks[p])
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def build_eval_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> ``loss_fn``'s metrics, without gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch, cfg)
        return metrics
    return eval_step


def build_prefill_logits_step(cfg: ModelConfig) -> Callable:
    """Forward over the full prompt; returns the last position's float32
    logits (B, V).  No KV is written: the serving engine's cache-writing
    prefill is ``build_prefill_step``."""

    @torch.no_grad()
    def prefill_logits_step(params, batch):
        hidden = forward(params, cfg, tokens=batch.get("tokens"),
                         embeds=batch.get("embeds"))
        w = lm_head_weight(params, cfg).to(hidden.dtype)
        return (hidden[:, -1] @ w).float()

    return prefill_logits_step


def gumbel_noise(seed: int, pos: int, vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise over the vocabulary for one request at one
    position.  It depends only on (seed, pos), and is drawn on the CPU so
    it is the same whatever device the logits lie on."""
    g = torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32)
                                      | (pos & 0xFFFFFFFF))
    u = torch.rand(vocab, generator=g, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def build_serve_step(cfg: ModelConfig, top_k: int = 0) -> Callable:
    """One decode step + head: (params, cache, tokens, pos) ->
    (next_token (B,), logits (B, V), cache).

    ``pos`` is a (B,) vector of per-slot positions (or a scalar).
    ``lm_weight`` / ``packed`` route the head and the block projections
    through ``kernels/ops.bitmap_spmm``.  Sampling: with ``seeds`` ((B,)
    ints) and ``temperature`` ((B,) float) a slot with T > 0 takes the
    Gumbel-max sample of ``logits / T``, its noise a function of (its
    seed, its position) only — so a request's sample at position p does
    not depend on scheduling; T == 0 slots stay exactly greedy.
    ``top_ks`` ((B,) ints, 0 = none) truncates each slot to its own
    top-k; without it ``top_k`` (given here) applies to every slot.
    ``page_tables`` ({bname: (B, page_slots) int64}) serves the KV cache
    from paged pools (``serve/paging.py``).
    """

    def serve_step(params, cache, tokens, pos, lm_weight=None, packed=None,
                   seeds=None, temperature=None, top_ks=None,
                   page_tables=None):
        logits, cache = decode_step(params, cache, cfg, tokens, pos,
                                    lm_weight=lm_weight, packed=packed,
                                    page_tables=page_tables)
        next_tok = logits.argmax(-1)
        if seeds is None or temperature is None:
            return next_tok, logits, cache
        b, vocab = logits.shape
        posv = pos.expand(b) if pos.dim() == 0 else pos
        hot = [i for i in range(b) if float(temperature[i]) > 0]
        if not hot:
            return next_tok, logits, cache
        pos_host = posv.cpu()
        for i in hot:
            scaled = logits[i] / max(float(temperature[i]), 1e-6)
            k = int(top_ks[i]) if top_ks is not None else top_k
            if k > 0:
                kth = torch.sort(scaled, descending=True).values[
                    min(k, vocab) - 1]
                scaled = scaled.masked_fill(scaled < kth, float("-inf"))
            noise = gumbel_noise(int(seeds[i]), int(pos_host[i]),
                                 vocab).to(scaled.device)
            next_tok[i] = (scaled + noise).argmax()
        return next_tok, logits, cache

    return serve_step


def build_prefill_step(cfg: ModelConfig) -> Callable:
    """One chunked-prefill call: (params, cache, tokens, pos, lens) ->
    (hidden (B, C, D), cache).

    ``tokens`` (B, C) holds one C-token slice of prompt per slot
    (``serve/prefill.PrefillPlanner``); ``pos`` (B,) each slot's chunk
    start and ``lens`` (B,) its valid tokens this call (0 = padding lane,
    writes nothing).  The C KV lines per slot are written into the cache
    in place; every projection runs at M = B·C (``packed`` routes them
    through the kernels, as in the decode step).  No LM head: the first
    token comes from the first decode step after prefill.
    ``page_tables`` as in the decode step.
    """

    def prefill_step(params, cache, tokens, pos, lens, packed=None,
                     page_tables=None):
        return prefill_hidden(params, cache, cfg, tokens, pos, lens,
                              packed=packed, page_tables=page_tables)

    return prefill_step

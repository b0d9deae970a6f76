"""The serving steps: the decode step (model step + LM head + token
choice) and the chunked-prefill call.

Port of ``repro/launch/steps.py:build_serve_step`` and
``build_prefill_step``.  Greedy argmax by default; slots with a
temperature above 0 sample from ``softmax(logits / T)``, optionally
truncated to their own top-k.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, prefill_hidden


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

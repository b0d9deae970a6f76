"""Step-function builders: train, eval, prefill logits, serve (decode)
and the chunked-prefill call.

Port of ``repro/launch/steps.py``.  The train step is
forward, backward through ``torch.autograd.grad`` and an in-place AdamW
update, with masked-gradient sparse training and gradient accumulation.
The serve step is greedy argmax by default; slots with a temperature
above 0 sample from ``softmax(logits / T)``, optionally truncated to
their own top-k, drawing the reference's ``jax.random.categorical``
from the reference's keys (``repro_torch.prng``).
``build_serve_step_spmd`` / ``build_prefill_step_spmd`` and
``build_train_step_spmd`` run those steps on a rank of a sharded world
(gather, then compute).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.counting import span
from repro_torch.launch.sharding import (batch_specs, bitmap_sharded,
                                         gather_leaf, opt_specs,
                                         param_specs, shard_leaf,
                                         sharded_on)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, forward, lm_head_weight,
                                      loss_fn, prefill_hidden)
from repro_torch.models.perf_flags import baseline_mode
from repro_torch.prng import categorical_rows, fold_in_rows, normal
from repro_torch.sparse.format import (all_gather_concat, all_reduce_sum,
                                       gather_bitmap)
from repro_torch.sparse.pruning import tree_items, tree_map
from repro_torch.train import optimizer as opt_lib


def loss_and_grads(params: Dict, batch: Dict, cfg: ModelConfig,
                   moe_global: bool = False):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; the grads a
    dict shaped as ``params``, in the params' dtype, zero for leaves the
    loss does not read (as ``jax.grad`` gives).  ``moe_global``: baseline
    mode's MoE dispatch (``models/perf_flags.py``)."""
    leaves = tree_items(params)
    with torch.enable_grad():
        live = {p: l.detach().requires_grad_(True) for p, l in leaves}
        loss, metrics = loss_fn(tree_map(lambda p, _: live[p], params),
                                batch, cfg, moe_global)
        # a leaf the arch never reads (olmo's norm scales) gets zeros
        grads = torch.autograd.grad(loss, list(live.values()),
                                    materialize_grads=True)
    flat = dict(zip(live, grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda p, _: flat[p], params)


def accumulated_grads(params: Dict, batch: Dict, cfg: ModelConfig,
                      accum_steps: int = 1,
                      moe_global: bool = False) -> Tuple[Dict, Dict]:
    """(grads, metrics) of one train step's batch.  ``accum_steps`` > 1
    splits it into that many equal microbatches (consecutive rows),
    sums their float32 gradients and divides by the count; the loss is
    the token-weighted mean."""
    if accum_steps == 1:
        _, metrics, grads = loss_and_grads(params, batch, cfg, moe_global)
        return grads, metrics
    gsum, lsum, csum = {}, 0, 0
    for i in range(accum_steps):
        micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                              *v.shape[1:])[i]
                 for k, v in batch.items()}
        _, m, g = loss_and_grads(params, micro, cfg, moe_global)
        for p, t in tree_items(g):
            gsum[p] = t.float() + gsum.get(p, 0)
        lsum = lsum + m["loss"] * m["tokens"]
        csum = csum + m["tokens"]
    grads = tree_map(lambda p, _: gsum[p] / accum_steps, params)
    return grads, {"loss": lsum / csum.clamp_min(1), "tokens": csum}


def build_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig,
                     prune_masks: Optional[Dict] = None,
                     accum_steps: int = 1,
                     baseline: Optional[bool] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    update written into ``params`` and ``opt_state`` in place.

    ``prune_masks`` (a tree shaped as params, bool or 0/1) multiplies the
    gradients before the update and the parameters after it, so pruned
    weights stay exactly zero (masked-gradient sparse training).
    ``accum_steps``: ``accumulated_grads``.  Metrics: ``loss``,
    ``tokens``, ``grad_norm``, ``lr`` (tensors on the device).
    ``baseline`` (None: ``perf_flags.baseline_mode()``, read here, once)
    takes baseline mode's MoE dispatch.
    """
    moe_global = baseline_mode(baseline)

    def train_step(params, opt_state, batch):
        with span("train.grads"):
            grads, metrics = accumulated_grads(params, batch, cfg,
                                               accum_steps, moe_global)
        with span("train.update"):
            if prune_masks is not None:
                masks = dict(tree_items(prune_masks))
                with torch.no_grad():            # the grads are this step's
                    for p, g in tree_items(grads):
                        g.mul_(masks[p])
            params, opt_state, opt_metrics = opt_lib.update(
                params, grads, opt_state, opt_cfg)
            if prune_masks is not None:
                with torch.no_grad():
                    for p, leaf in tree_items(params):
                        leaf.mul_(masks[p])
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def build_eval_step(cfg: ModelConfig,
                    baseline: Optional[bool] = None) -> Callable:
    """(params, batch) -> ``loss_fn``'s metrics, without gradients;
    ``baseline`` as in ``build_train_step``."""
    moe_global = baseline_mode(baseline)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch, cfg, moe_global)
        return metrics
    return eval_step


def build_prefill_logits_step(cfg: ModelConfig,
                              baseline: Optional[bool] = None) -> Callable:
    """Forward over the full prompt; returns the last position's float32
    logits (B, V).  No KV is written: the serving engine's cache-writing
    prefill is ``build_prefill_step``.  ``baseline`` as in
    ``build_train_step``."""
    moe_global = baseline_mode(baseline)

    @torch.no_grad()
    def prefill_logits_step(params, batch):
        hidden = forward(params, cfg, tokens=batch.get("tokens"),
                         embeds=batch.get("embeds"), moe_global=moe_global)
        w = lm_head_weight(params, cfg).to(hidden.dtype)
        return (hidden[:, -1] @ w).float()

    return prefill_logits_step


def build_serve_step(cfg: ModelConfig, top_k: int = 0,
                     baseline: Optional[bool] = None) -> Callable:
    """One decode step + head: (params, cache, tokens, pos) ->
    (next_token (B,), logits (B, V), cache).

    ``pos`` is a (B,) vector of per-slot positions (or a scalar).
    ``lm_weight`` / ``packed`` route the head and the block projections
    through ``kernels/ops.bitmap_spmm``.  Sampling, as the reference's
    step samples: with ``sample_keys`` ((B, 2) int64, one
    ``prng.prng_key`` per slot) and ``temperature`` ((B,) float32), both
    on the logits' device, each slot's key is folded with its position
    and a slot with T > 0 takes ``jax.random.categorical`` of
    ``logits / max(T, 1e-6)``; T == 0 slots stay exactly greedy.  So a
    request's sample at position p depends only on (its key, p), not on
    scheduling.  ``top_ks`` ((B,) int) truncates each slot to the values
    at or above its own k-th largest (0 = none); without it ``top_k``
    (given here) applies to every slot.  The whole draw runs over the
    slot batch on the device, with no read back to the host.
    ``page_tables`` ({bname: (B, page_slots) int64}) serves the KV cache
    from paged pools (``serve/paging.py``).

    ``embed_key`` (the frames frontend, ``tokens`` None): a
    ``repro_torch.prng`` key from which the step draws the (B, 1, D)
    float32 frame embeddings on the device, B the whole slot batch (idle
    slots included), as the reference's ``jax.random.normal`` does;
    ``embeds`` gives them instead (the dry run's inputs).
    ``baseline`` as in ``build_train_step``.
    """
    moe_global = baseline_mode(baseline)

    def serve_step(params, cache, tokens, pos, lm_weight=None, packed=None,
                   sample_keys=None, temperature=None, top_ks=None,
                   page_tables=None, embed_key=None, embeds=None):
        if embed_key is not None:
            b = pos.shape[0] if pos.dim() else 1
            embeds = normal(embed_key, (b, 1, cfg.d_model),
                            device=pos.device)
        logits, cache = decode_step(params, cache, cfg, tokens, pos,
                                    embeds=embeds, lm_weight=lm_weight,
                                    packed=packed, page_tables=page_tables,
                                    moe_global=moe_global)
        next_tok = logits.argmax(-1)
        if sample_keys is None or temperature is None:
            return next_tok, logits, cache
        b, vocab = logits.shape
        keys = fold_in_rows(sample_keys, pos.expand(b))
        scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
        if top_ks is not None:
            # each row keeps the values at or above its own k-th largest;
            # k <= 0 rows keep the whole distribution
            desc = scaled.sort(dim=-1, descending=True).values
            kth = desc.gather(1, (top_ks.long() - 1).clamp(0, vocab - 1)
                              [:, None])
            scaled = scaled.masked_fill((top_ks[:, None] > 0)
                                        & (scaled < kth), float("-inf"))
        elif top_k > 0:
            kth = scaled.topk(min(top_k, vocab), dim=-1).values[:, -1:]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        sampled = categorical_rows(keys, scaled)
        return torch.where(temperature > 0, sampled, next_tok), logits, cache

    return serve_step


def build_prefill_step(cfg: ModelConfig,
                       baseline: Optional[bool] = None) -> Callable:
    """One chunked-prefill call: (params, cache, tokens, pos, lens) ->
    (hidden (B, C, D), cache).

    ``tokens`` (B, C) holds one C-token slice of prompt per slot
    (``serve/prefill.PrefillPlanner``); ``pos`` (B,) each slot's chunk
    start and ``lens`` (B,) its valid tokens this call (0 = padding lane,
    writes nothing).  The C KV lines per slot are written into the cache
    in place; every projection runs at M = B·C (``packed`` routes them
    through the kernels, as in the decode step).  No LM head: the first
    token comes from the first decode step after prefill.
    ``page_tables`` and ``baseline`` as in the decode step.
    """
    moe_global = baseline_mode(baseline)

    def prefill_step(params, cache, tokens, pos, lens, packed=None,
                     page_tables=None):
        return prefill_hidden(params, cache, cfg, tokens, pos, lens,
                              packed=packed, page_tables=page_tables,
                              moe_global=moe_global)

    return prefill_step


# ---------------------------------------------------------------- SPMD ----
# Sharded serving: the decode and prefill steps above, run by every rank
# of the engine's (data, model) mesh.  Each rank stores its part of every
# model-sharded packed weight (``sparse.format.keep_part``), of every
# dense parameter (``param_specs``) and its shard of each data-sharded
# paged KV pool (``PagedKVCache(local_shard=...)``).  The step is
# gather-then-compute: the parts and pool chunks are all-gathered, with
# the dense leaves the step reads (those served dense: no packed form, or
# quarantined), the *unchanged* base step runs on the whole weights and
# pools, and each rank keeps its own chunk of the written pools.  So the
# tokens are those of the one-rank step by construction, while each rank
# stores 1/S of every model-sharded tensor.  The gathered copies live for
# one call.


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GatherStats:
    """What a sharded step's collectives cost on this rank: calls, host
    seconds (synchronised on a card), bytes received, and the part of
    them that is dense parameters."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.seconds = 0.0
        self.bytes_received = 0
        self.dense_bytes_received = 0

    def add(self, seconds: float, received: int, dense: int = 0) -> None:
        self.calls += 1
        self.seconds += seconds
        self.bytes_received += received
        self.dense_bytes_received += dense

    def report(self) -> Dict:
        n = max(self.calls, 1)
        return {"calls": self.calls, "ms_per_call": 1e3 * self.seconds / n,
                "bytes_received_per_call": self.bytes_received // n,
                "dense_bytes_received_per_call":
                    self.dense_bytes_received // n}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather_weight(bw, mesh) -> Tuple[object, int]:
    """(whole weight, bytes received) of a rank's part, or ``bw`` as it
    is when it is not sharded over the mesh's model axis."""
    if not bitmap_sharded(bw, mesh):
        return bw, 0
    full = gather_bitmap(bw, mesh.group("model"))
    return full, (bw.parts - 1) * bw.resident_bytes


def _gather_packed(tree, mesh) -> Tuple[Optional[Dict], int]:
    """Every model-sharded weight of a packed block tree gathered whole
    (replicated and ``None`` leaves pass through), and the bytes
    received."""
    if tree is None:
        return None, 0
    out, got = {}, 0
    for bname, bdict in tree.items():
        out[bname] = {}
        for comp, tensors in bdict.items():
            out[bname][comp] = {}
            for name, bw in tensors.items():
                out[bname][comp][name], n = _gather_weight(bw, mesh)
                got += n
    return out, got


def _gather_model(tree: Dict, specs: Dict, mesh,
                  paths: Optional[frozenset] = None) -> Tuple[Dict, int]:
    """(the tree with its model-sharded leaves gathered whole, bytes
    received).  ``paths`` limits the gather to those leaves (the others
    stay this rank's parts, which the caller does not read); a bool leaf
    travels as bits."""
    got = 0
    whole = {}
    for p, t in tree_items(tree):
        if (paths is None or p in paths) and sharded_on(specs[p], "model",
                                                        mesh):
            whole[p] = gather_leaf(t, specs[p], mesh, ("model",))
            got += (mesh.model - 1) * (-(-t.numel() // 8)
                                       if t.dtype == torch.bool
                                       else _nbytes(t))
    return tree_map(lambda p, t: whole.get(p, t), tree), got


def _gather_cache(cache: Dict, pools: frozenset, mesh) -> Tuple[Dict, int]:
    """The whole page pools (axis 1, after the period stack) gathered
    from every rank's chunk over the data axis (page ids in the tables
    are global); every other leaf is this rank's own, replicated."""
    if mesh.data <= 1 or not pools:
        return cache, 0
    out, got = {}, 0
    for bname, leafd in cache.items():
        if bname not in pools:
            out[bname] = leafd
            continue
        out[bname] = dict(leafd)
        for key in ("k", "v"):
            local = leafd[key]
            full = torch.empty((mesh.data * local.shape[0],
                                *local.shape[1:]), dtype=local.dtype,
                               device=local.device)
            all_gather_concat(full, local, mesh.group("data"))
            out[bname][key] = full.view(mesh.data, *local.shape).movedim(
                0, 1).reshape(
                local.shape[0], mesh.data * local.shape[1],
                *local.shape[2:])
            got += (mesh.data - 1) * _nbytes(local)
    return out, got


def _slice_cache(cache: Dict, full: Dict, pools: frozenset, mesh) -> None:
    """Inverse of ``_gather_cache``: copy this rank's chunk of each
    written pool back into its own pool.  The allocator maps every slot's
    pages (and its idle writes) inside its own shard's range, so the
    chunk holds exactly this rank's slots' lines."""
    if mesh.data <= 1 or not pools:
        return
    d = mesh.data_rank
    for bname in pools:
        for key in ("k", "v"):
            local = cache[bname][key]
            n = local.shape[1]
            local.copy_(full[bname][key][:, d * n:(d + 1) * n])


def _timed_gathers(params, cache, packed, lm_weight, pools, mesh, specs,
                   dense, stats):
    """Gather the step's sharded operands, timed into ``stats``."""
    t0 = time.perf_counter()
    full_cache, got_kv = _gather_cache(cache, pools, mesh)
    full_packed, got_w = _gather_packed(packed, mesh)
    lm, got_head = _gather_weight(lm_weight, mesh)
    view, got_dense = _gather_model(params, specs, mesh, dense)
    dev = next((t.device for leafd in cache.values()
                for t in leafd.values()), None)
    if dev is not None:
        _sync(dev)
    stats.add(time.perf_counter() - t0,
              got_kv + got_w + got_head + got_dense, got_dense)
    return view, full_cache, full_packed, lm


def build_serve_step_spmd(cfg: ModelConfig, mesh, top_k: int = 0,
                          data_pools: Sequence[str] = (),
                          baseline: Optional[bool] = None) -> Callable:
    """``build_serve_step`` for a rank of ``mesh``: the same signature
    and the same tokens, from sharded storage.  ``params`` holds this
    rank's parts by ``param_specs(cfg, mesh)``; ``dense`` (a keyword of
    the step) names the model-sharded leaves the step reads densely,
    which it gathers (the engine's ``dense_gather``).  ``data_pools``:
    the paged pools whose pages are sharded over the data axis (the
    engine passes its pool names when ``kv.shards`` equals the data
    extent); packed weights are gathered where they are sharded over the
    model axis (``sharding.bitmap_sharded``).  ``serve_step.stats`` is
    the gathers' ``GatherStats``.  ``baseline`` as in the one-rank step."""
    baseline = baseline_mode(baseline)
    base = build_serve_step(cfg, top_k=top_k, baseline=baseline)
    pools = frozenset(data_pools)
    specs = dict(tree_items(param_specs(cfg, mesh, baseline=baseline)))
    stats = GatherStats()

    def serve_step(params, cache, tokens, pos, lm_weight=None, packed=None,
                   sample_keys=None, temperature=None, top_ks=None,
                   page_tables=None, embed_key=None, dense=frozenset()):
        view, full_cache, full_packed, lm = _timed_gathers(
            params, cache, packed, lm_weight, pools, mesh, specs, dense,
            stats)
        # every rank draws the same frame embeddings from the same key
        nxt, logits, full_cache = base(
            view, full_cache, tokens, pos, lm_weight=lm,
            packed=full_packed, sample_keys=sample_keys,
            temperature=temperature, top_ks=top_ks,
            page_tables=page_tables, embed_key=embed_key)
        _slice_cache(cache, full_cache, pools, mesh)
        return nxt, logits, cache

    serve_step.stats = stats
    return serve_step


def build_prefill_step_spmd(cfg: ModelConfig, mesh,
                            data_pools: Sequence[str] = (),
                            baseline: Optional[bool] = None) -> Callable:
    """``build_prefill_step`` for a rank of ``mesh``: the chunked-prefill
    counterpart of ``build_serve_step_spmd`` (the same gathers, no
    head)."""
    baseline = baseline_mode(baseline)
    base = build_prefill_step(cfg, baseline=baseline)
    pools = frozenset(data_pools)
    specs = dict(tree_items(param_specs(cfg, mesh, baseline=baseline)))
    stats = GatherStats()

    def prefill_step(params, cache, tokens, pos, lens, packed=None,
                     page_tables=None, dense=frozenset()):
        view, full_cache, full_packed, _ = _timed_gathers(
            params, cache, packed, None, pools, mesh, specs, dense, stats)
        hidden, full_cache = base(view, full_cache, tokens, pos, lens,
                                  packed=full_packed,
                                  page_tables=page_tables)
        _slice_cache(cache, full_cache, pools, mesh)
        return hidden, cache

    prefill_step.stats = stats
    return prefill_step


# ------------------------------------------------------ SPMD training ----
# Sharded training: every rank of the (data, model) mesh holds its part
# of each parameter and mask (``param_specs``: the model axis) and of
# each Adam moment (``opt_specs``: ZeRO-1 over the data axis too).  The
# step is gather-then-compute around the unchanged ``loss_and_grads``:
# the parts are gathered over ``model`` into whole parameters, each data
# rank takes its rows of the batch, the gradients are summed over
# ``data``, and each rank updates the block of its part that its moments
# cover, clipped by the whole gradient's norm, then gathers the blocks
# over ``data`` to rebuild its part.


def _batch_rows(batch: Dict, cfg: ModelConfig, mesh, moe_global: bool
                ) -> Optional[Tuple[int, int]]:
    """This rank's rows [r0, r1) of the batch (``batch_specs``: over the
    batch axes, pod × data), or None when the batch is not split: batch
    axes of 1, rows that do not divide over them, or baseline mode's
    global MoE dispatch, whose capacity ranks the whole batch's tokens
    (every rank then takes the whole batch)."""
    b = batch["targets"].shape[0]
    if (mesh.batch == 1 or batch_specs(cfg, mesh, b)("targets")[0] is None
            or (cfg.num_experts and moe_global)):
        return None
    per = b // mesh.batch
    return mesh.batch_rank * per, (mesh.batch_rank + 1) * per


def _split_grads(params: Dict, batch: Dict, cfg: ModelConfig,
                 rows: Tuple[int, int], accum_steps: int,
                 moe_global: bool):
    """(grads, loss sum) of this rank's rows.  Each microbatch's part is
    weighted by its share of that microbatch's live targets (counted over
    the whole batch, which every rank has), so that the sum over the data
    ranks is the one-rank step's token-weighted gradient, whatever the
    ranks' numbers of live targets."""
    r0, r1 = rows
    m = batch["targets"].shape[0] // accum_steps
    live = (batch["targets"] >= 0).reshape(accum_steps, -1).sum(1).float()
    gsum, lsum = {}, 0
    for i in range(accum_steps):
        a, e = max(r0, i * m), min(r1, (i + 1) * m)
        if a >= e:
            continue
        _, met, g = loss_and_grads(params, {k: v[a:e]
                                            for k, v in batch.items()}, cfg,
                                   moe_global)
        w = met["tokens"] / live[i].clamp_min(1)
        for p, t in tree_items(g):
            gsum[p] = t.float() * w + gsum.get(p, 0)
        lsum = lsum + met["loss"] * met["tokens"]
    return tree_map(lambda p, _: gsum[p] / accum_steps, params), lsum


def build_train_step_spmd(cfg: ModelConfig, opt_cfg: opt_lib.OptConfig,
                          mesh, prune_masks: Optional[Dict] = None,
                          accum_steps: int = 1,
                          baseline: Optional[bool] = None) -> Callable:
    """``build_train_step`` for a rank of ``mesh``: (params, opt_state,
    batch) -> (params, opt_state, metrics), with ``params`` and
    ``prune_masks`` this rank's parts by ``param_specs`` and the moments
    its parts by ``opt_specs`` (``launch.sharding.shard_tree``), written
    in place.  ``batch`` is the whole step's batch on every rank.

    The loss is the token-weighted global mean, as the one-rank
    ``lm_loss`` computes it; ``accum_steps`` keeps the one-rank rule (the
    microbatches' gradients summed and divided by the count).  With a
    data axis of 1 each rank runs the one-rank arithmetic on the whole
    parameters, so the result is the one-rank step's bit for bit.  The
    metrics are equal on every rank.  ``train_step.stats``: the gathers'
    and the all-reduces' ``GatherStats`` (an all-reduce's bytes are what
    a ring receives, 2·(n−1)/n of the tensor).  ``baseline`` (None:
    ``perf_flags.baseline_mode()``, read here, once) takes baseline
    mode's specs and MoE dispatch; the params and moments must then be
    sharded by ``param_specs`` / ``opt_specs`` with the same flag."""
    baseline = baseline_mode(baseline)
    pspecs = dict(tree_items(param_specs(cfg, mesh, baseline=baseline)))
    ospecs = dict(tree_items(opt_specs(cfg, mesh, baseline=baseline)["m"]))
    # the ZeRO-1 block of a rank's part: its moments' data-axis slice
    zspecs = {p: tuple(e if e == "data" else None for e in s)
              for p, s in ospecs.items()}
    stats = {"gather": GatherStats(), "all_reduce": GatherStats()}

    def train_step(params, opt_state, batch):
        dev = batch["targets"].device
        t0 = time.perf_counter()
        full, got = _gather_model(params, pspecs, mesh)
        masks = None
        if prune_masks is not None:
            masks, n = _gather_model(prune_masks, pspecs, mesh)
            masks, got = dict(tree_items(masks)), got + n
        _sync(dev)
        gather_s = time.perf_counter() - t0
        rows = _batch_rows(batch, cfg, mesh, baseline)
        if rows is None:
            with span("train.grads"):
                grads, metrics = accumulated_grads(full, batch, cfg,
                                                   accum_steps, baseline)
        else:
            with span("train.grads"):
                grads, lsum = _split_grads(full, batch, cfg, rows,
                                           accum_steps, baseline)
            _sync(dev)
            t0 = time.perf_counter()
            group = mesh.group("batch")
            reduced = 0
            for _, g in tree_items(grads):
                all_reduce_sum(g, group)
                reduced += _nbytes(g)
            lsum = all_reduce_sum(lsum.reshape(1), group)[0]
            _sync(dev)
            stats["all_reduce"].add(time.perf_counter() - t0,
                                    2 * (mesh.batch - 1) * reduced
                                    // mesh.batch)
            tokens = (batch["targets"] >= 0).sum().float()
            metrics = {"loss": lsum / tokens.clamp_min(1), "tokens": tokens}
        del full
        flat_p = dict(tree_items(params))
        with torch.no_grad(), span("train.update"):
            if masks is not None:
                for p, g in tree_items(grads):
                    g.mul_(masks[p])
            gnorm = opt_lib.global_norm(grads)
            blocks = tree_map(lambda p, t: shard_leaf(t, zspecs[p], mesh),
                              params)
            gblocks = tree_map(lambda p, g: shard_leaf(g, ospecs[p], mesh),
                               grads)
            _, opt_state, opt_metrics = opt_lib.update(
                blocks, gblocks, opt_state, opt_cfg, gnorm=gnorm)
            del grads, gblocks
            t0 = time.perf_counter()
            for p, block in tree_items(blocks):
                if masks is not None:
                    block.mul_(shard_leaf(masks[p], ospecs[p], mesh))
                if sharded_on(zspecs[p], "data", mesh):
                    flat_p[p].copy_(gather_leaf(block, zspecs[p], mesh,
                                                ("data",)))
                    got += (mesh.data - 1) * _nbytes(block)
            _sync(dev)
        stats["gather"].add(gather_s + time.perf_counter() - t0, got)
        return params, opt_state, {**metrics, **opt_metrics}

    train_step.stats = stats
    return train_step

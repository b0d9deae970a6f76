"""Continuous-batching serving engine over the packed decode stack.

Port of ``repro/serve/engine.py``:

* a request queue and a slot scheduler that admits new requests into
  freed batch slots mid-flight (``serve/request.py``,
  ``serve/scheduler.py``, copies of the reference's);
* a slotted contiguous KV cache reused across request lifetimes
  (``serve/cache.py``), or with ``paged=True`` a paged one
  (``serve/paging.py``): fixed-size pages allocated lazily off a free
  list and read through per-slot page tables, with shared-prefix reuse
  (``prefix_reuse``) and recompute-on-preempt (``preempt``, bounded by
  ``max_preempts``);
* weights pruned once (``global_l1_prune``) and the whole decode stack
  packed once into the paper's ``BitmapWeight`` format
  (``serve/packed.py``), plus the per-tensor-pruned LM head: every
  attention, MLP, mamba and RWKV projection and the head go through
  ``kernels/ops.bitmap_spmm`` on every decode step, and every MoE
  expert stack and RWKV's ``mix_B`` through
  ``kernels/ops.bitmap_spmm_grouped`` — on the card, the hand-written
  CUDA kernels;
* prompts are walked one position per decode step (teacher forcing),
  or, with ``prefill_chunk`` > 0, ingested ``prefill_chunk`` tokens at a
  time through one batched chunked-prefill call per engine step
  (``serve/prefill.py``; token-identical to the walk); each slot decodes
  at its own position.

**Request lifecycle and failure semantics**: every request ends in
exactly one terminal state — DONE, CANCELLED (``cancel(rid)``, valid
queued, mid-prefill, mid-decode and mid-preempt-replay), EXPIRED
(``deadline_ms`` elapsed) or SHED (admission control under overload,
``max_queue`` / ``ttft_budget_ms``, raises or records the typed
``ServeOverloaded``).  ``audit=True`` runs the step-level invariant
auditor (``serve/faults.InvariantAuditor``) and integrity-scans the
packed tensors: a corrupted tensor (a seeded ``FaultPlan`` bitflip, a
NaN-poisoned head, or real bit-rot) is quarantined to its dense form
with a recorded manifest reason, and every in-flight request replays
instead of serving garbage.  ``faults`` fires a seeded ``FaultPlan`` at
each step start.  Every counter and histogram lives in one
``MetricsRegistry`` (``serve/telemetry.py``) and ``report()`` is its
rendered snapshot; ``trace_out`` / ``events_out`` / ``metrics_out``
add step-phase spans, a Chrome trace, a JSONL event log and a metrics
snapshot, and ``traffic_out`` the per-role HBM ledger
(``serve/traffic.py``), all written by ``close()``.

It runs on ``cuda`` unless the caller passes ``device="cpu"`` (the CPU
takes the kernels' plain versions); with no card and no explicit CPU it
raises.  Recurrent blocks (mamba, RWKV6 and its channel-mix) serve by
the prompt walk, their per-slot state zeroed on every admission, a
re-admission after preemption or quarantine included.  The frames
frontend (musicgen) feeds each decode step embeddings drawn on the
device from the reference's key, ``PRNGKey(seed + 0x5eed)`` folded with
the step counter, replayed without JAX by ``repro_torch.prng``; so it
serves the reference's tokens.  Sampled requests (T > 0) draw the
reference's ``jax.random.categorical`` from its per-request key,
``PRNGKey(seed)`` folded with the slot's position, replayed on the
device by the same module; so they serve the reference's tokens too.
Baseline mode (``REPRO_PERF_MODE``,
``models/perf_flags.py``) is read once, when the engine is built, and
its steps take the global MoE dispatch.  The traffic ledger's
cross-check counts the engine's own steps on meta tensors
(``serve/traffic.py``, ``launch/counters.py``).

**Sharded serving.**  In a ``torch.distributed`` world of more than one
rank, every rank builds the same engine and runs the same host loop (the
same trace, the same seeded draws, so the same decisions) on the
elastic (data, model) mesh of ``launch/mesh.py``.  With
``model_parallel`` > 1 the stack and the vocabulary-split head are
packed sharded (``pack_model(shards=...)``) and each rank keeps its
model-axis part; paged KV pools shard their pages over the data axis
(``kv_shards``, default the data extent).  The dense ``params`` are
stored by ``launch/sharding.param_specs(cfg, mesh)`` (as the reference
places them): each rank keeps its part of every model-sharded leaf.
The steps gather the parts and pool chunks, and the dense leaves they
read (``dense_gather``: those with no packed form or quarantined, all
of them with ``stream_weights=False``), around the unchanged base step
(``launch/steps.build_serve_step_spmd``).  The reference's rules leave
the embedding and an untied head replicated (their ``embed$`` and
``lm_head$`` patterns never match a key path, which ends in ``']``), so
each rank looks tokens up in its own copy.  So the tokens are the
one-rank engine's.  The typed fallbacks ``head_shard`` and ``kv_shard`` carry
the reference's reasons.  Decisions taken on the wall clock (deadlines,
TTFT shedding) read one clock for the world: rank 0's, broadcast once
per step (``Mesh.from_root``), so every rank expires and sheds alike;
every time stamp of a step is that reading.  A world of one rank serves
exactly as before: asked for ``model_parallel`` > 1 it builds the
clamped (1, 1) mesh, as the reference's ``make_elastic_mesh`` does on one
device, and ``kv_shards`` > 1 is ignored there, as the reference ignores
it off a sharded mesh.

A quarantined LM head is served dense from the params' head as it stands
(the reference's ``lm_weight = None``).
"""
from __future__ import annotations

import math
import os
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.launch.sharding import (keep_local, keep_local_tree,
                                         param_specs, resident_bytes,
                                         shard_tree, sharded_on)
from repro_torch.launch.steps import (build_prefill_step,
                                      build_prefill_step_spmd,
                                      build_serve_step,
                                      build_serve_step_spmd)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, lm_head_weight
from repro_torch.models.perf_flags import baseline_mode
from repro_torch.prng import fold_in, prng_key
from repro_torch.serve.cache import SlotKVCache
from repro_torch.serve.errors import (DeadlineExceeded, OutOfPages,
                                      RequestRejected, ServeOverloaded)
from repro_torch.serve.faults import FaultPlan, InvariantAuditor
from repro_torch.serve.packed import (ROUTED_EXPERT, PackedModel,
                                      activated_scale, choose_block,
                                      pack_model)
from repro_torch.serve.paging import PagedKVCache
from repro_torch.serve.prefill import PrefillPlanner
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.telemetry import Clock, MetricsRegistry, Telemetry
from repro_torch.serve.traffic import TrafficLedger
from repro_torch.sparse.format import BitmapWeight, pack_bitmap, shard_bitmap
from repro_torch.sparse.pruning import (global_l1_prune, per_tensor_prune,
                                        sparsity_of, tree_items, tree_map)


def _head_block(d_model: int, vocab: int, cap: int = 128):
    """Largest (BK, BN) bitmap tile that divides the head; BN % 8 == 0."""
    return choose_block(d_model, vocab, cap)


def pack_lm_head(params, cfg: ModelConfig, sparsity: float = 0.0,
                 cache_dense: bool = False,
                 shards: int = 1) -> Optional[BitmapWeight]:
    """Prune (per tensor) and pack the (D, V) LM head once for serving.

    ``shards`` > 1 asks for the vocabulary-split (column-parallel)
    layout: the head packs against a tile of the per-shard (D, V/S)
    slice and ``shard_bitmap`` splits it, so that each rank can keep 1/S
    of it.  When V % S != 0, or no per-shard tile fits, it packs
    replicated (``shard`` None; the engine records the reason)."""
    block = _head_block(cfg.d_model, cfg.vocab_size)
    if block is None:
        return None
    w = lm_head_weight(params, cfg)
    if sparsity > 0:
        w = per_tensor_prune(w, sparsity)
    w = w.float().contiguous()
    if shards > 1 and cfg.vocab_size % shards == 0:
        sblock = _head_block(cfg.d_model, cfg.vocab_size // shards)
        if sblock is not None:
            return shard_bitmap(pack_bitmap(w, block=sblock,
                                            cache_dense=cache_dense),
                                shards, "col")
    return pack_bitmap(w, block=block, cache_dense=cache_dense)


def prefill_fallback(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` keeps the prompt walk when chunked prefill is asked
    for (the reference's reasons), or None: the frames frontend derives
    its embeds from the step counter, and recurrent mixer state advances
    one token per step."""
    if cfg.frontend == "frames":
        return (f"{cfg.name}: frames frontend derives per-step embeds "
                f"from the step counter; nothing to prefill")
    if any(b.mixer != "attn" or b.ffn == "rwkv_cm" for b in cfg.pattern):
        return (f"{cfg.name}: recurrent mixer state (mamba/rwkv) has "
                f"no chunked prefill path yet; teacher-forcing kept")
    return None


def kv_fallbacks(cfg: ModelConfig, paged: bool, prefix_reuse: bool,
                 preempt: bool) -> Dict[str, Optional[str]]:
    """Why ``cfg`` falls back from paging, prefix reuse or preemption
    (the reference's reasons, None where the knob holds or is off):
    paging needs an attention block; reuse needs paging, and prompt
    tokens that fix the whole state (no frames frontend, no recurrent
    mixer); preemption needs paging and a frontend that does not fold
    the step counter."""
    out: Dict[str, Optional[str]] = {"paging": None, "prefix_reuse": None,
                                     "preempt": None}
    if paged and not any(b.mixer == "attn" for b in cfg.pattern):
        paged = False
        out["paging"] = (f"{cfg.name}: no attention blocks — recurrent "
                         f"state is O(1)/slot, nothing to page")
    recurrent = any(b.mixer != "attn" or b.ffn == "rwkv_cm"
                    for b in cfg.pattern)
    if prefix_reuse:
        if not paged:
            out["prefix_reuse"] = ("paged KV cache disabled (or fell back "
                                   "to contiguous); no pages to share")
        elif cfg.frontend == "frames":
            out["prefix_reuse"] = (
                f"{cfg.name}: frames frontend derives embeds from the step "
                f"counter; prompt-token hashing is meaningless")
        elif recurrent:
            out["prefix_reuse"] = (
                f"{cfg.name}: recurrent mixer state (mamba/rwkv) is not "
                f"captured by KV pages; skipping ingestion would drop it")
    if preempt:
        if not paged:
            out["preempt"] = ("paged KV cache disabled (or fell back to "
                              "contiguous); no pages to reclaim")
        elif cfg.frontend == "frames":
            out["preempt"] = (
                f"{cfg.name}: frames embeds fold the global step counter, "
                f"so a preempted request's recompute would diverge from "
                f"its first run")
    return out


_KV_WARNINGS = {"paging": "paged KV cache fell back to contiguous",
                "prefix_reuse": "shared-prefix reuse fell back",
                "preempt": "recompute-on-preempt fell back"}


class ServeEngine:
    """Continuous-batching decode over ``num_slots`` batch slots."""

    def __init__(self, cfg: ModelConfig, *, num_slots: int = 4,
                 max_len: int = 128, sparsity: float = 0.0, seed: int = 0,
                 model_parallel: int = 1, bitmap_head: bool = True,
                 head_sparsity: Optional[float] = None,
                 stream_weights: bool = True, top_k: int = 0,
                 paged: bool = False, page_len: int = 16,
                 page_pool_tokens: Optional[int] = None,
                 kv_shards: Optional[int] = None,
                 prefill_chunk: int = 0, prefix_reuse: bool = False,
                 preempt: bool = False, max_preempts: int = 8,
                 history: int = 512,
                 deadline_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 ttft_budget_ms: Optional[float] = None,
                 audit: bool = False,
                 faults: Optional[FaultPlan] = None,
                 trace_out: Optional[str] = None,
                 events_out: Optional[str] = None,
                 metrics_out: Optional[str] = None,
                 traffic_out: Optional[str] = None,
                 params: Optional[Dict] = None,
                 device: torch.device | str | None = None):
        """``params``: the model's weights as a dict in the port's layout
        (``repro_torch.bridge.params_from_numpy`` makes one from the JAX
        package's); without it the engine draws its own from ``seed``.

        ``head_sparsity``: the LM head is pruned per tensor to this level
        (default ``sparsity``) before packing; 0.0 streams the exact dense
        head through the bitmap path.  ``stream_weights=False`` serves a
        dense-dispatch baseline.  ``top_k``: default top-k
        truncation for sampled requests.  ``prefill_chunk`` > 0 ingests
        admitted prompts that many tokens at a time, one batched call per
        engine step (0: the prompt walk, one token per decode step).

        ``paged``: page the attention KV cache into ``page_len``-token
        pages read through per-slot page tables (``serve/paging.py``);
        ``page_pool_tokens`` bounds each pool (default: the worst case,
        still allocated lazily), and a request that does not fit queues
        until retirements free pages.  ``prefix_reuse`` (paged): a new
        request adopts the resident pages of a matching prompt prefix
        copy-on-write and skips their prefill.  ``preempt`` (paged):
        admission commits only the live ingest pages; when the pool runs
        dry the engine evicts cached prefixes, then preempts the
        youngest slot, whose request re-queues at the head of the line
        and re-ingests its prompt and generated tokens on re-admission.
        A request preempted ``max_preempts`` times re-admits pinned:
        with its worst-case commitment, and never a victim again.
        Tokens are the same with any of these on or off; each falls back
        with the reference's recorded reason when it cannot hold.

        ``model_parallel`` / ``kv_shards``: sharded serving in a
        ``torch.distributed`` world (see the module docstring): the
        packed stack and head sharded over the model axis of the largest
        (data, model) mesh with ``model <= model_parallel``, paged KV
        pools over its data axis (``kv_shards`` None: the data extent;
        a count that is not the data extent or does not divide
        ``num_slots`` keeps the pools replicated, with a typed reason).
        A world of one rank clamps them to 1.  Every rank must make the
        same engine and drive it with the same calls.

        ``history``: retired requests kept for inspection.

        ``deadline_ms``: default per-request latency budget from the
        moment a request's arrival comes due; a request that blows it,
        queued or mid-flight, ends EXPIRED with ``DeadlineExceeded``
        (``submit(deadline_ms=...)`` overrides it per request).
        ``max_queue`` / ``ttft_budget_ms``: load shedding — a request
        that comes due while ``max_queue`` requests already wait, or
        while the estimated TTFT exceeds the budget, is shed with
        ``ServeOverloaded`` (raised by ``submit`` for a request due now,
        recorded on the request otherwise).  None: no deadline, no
        shedding.

        ``audit``: check the step's invariants after every step (slots,
        page refcounts, request states, finite logits) and scan the
        packed tensors' checksums; a corrupted tensor is quarantined to
        its dense form and every in-flight request replays.  ``faults``:
        a seeded ``serve/faults.FaultPlan`` fired at each step start.

        ``trace_out`` / ``events_out`` / ``metrics_out``: telemetry
        artifacts written by ``close()`` (Chrome trace of step phases and
        request lifecycles, JSONL event log, metrics snapshot — JSON, or
        Prometheus text for ``.prom``).  Any of them turns step-phase
        spans on; with none the spans and events are ``None`` and cost
        one ``is not None`` check per bracket.  ``traffic_out``: the
        traffic ledger's artifact (``serve/traffic.py``).
        """
        self.device = resolve_device(device)
        self.mesh = make_elastic_mesh(model_parallel, self.device.type)
        self._spmd = self.mesh.size > 1
        self.model_parallel = self.mesh.model
        self.cfg = cfg
        self.metrics = MetricsRegistry()
        self._clock = Clock()
        # a sharded world decides on one clock: rank 0's reading at the
        # start of each step, broadcast (``_tick``); one rank reads its own
        self._now: Optional[float] = None
        self._last_now: Optional[float] = None
        self._steps = 0
        # telemetry first: the fallback warnings below emit into the
        # event log
        self.telemetry: Optional[Telemetry] = None
        if trace_out or events_out or metrics_out:
            self.telemetry = Telemetry(self.metrics, self._clock,
                                       trace_out=trace_out,
                                       events_out=events_out,
                                       metrics_out=metrics_out)
        self.spans = (self.telemetry.spans
                      if self.telemetry is not None else None)
        self.events = (self.telemetry.events
                       if self.telemetry is not None else None)
        self.num_slots = num_slots
        self.max_len = max_len
        self.sparsity = sparsity
        self.fallbacks: Dict[str, str] = {}
        self._warned: set = set()

        t0 = time.perf_counter()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg, device=self.device)
        else:
            params = tree_map(lambda _, t: t.to(self.device), params)
        self._sync()
        self.init_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        if sparsity > 0:
            params = global_l1_prune(params, sparsity)
        self.weight_sparsity = sparsity_of(params) if sparsity > 0 else 0.0
        # every leaf's whole shape: a sharded rank keeps parts of them
        self.dense_shapes = {p: tuple(t.shape) for p, t in tree_items(params)}
        self.params = params
        # a dense rendering beside each pack serves the plain version on
        # the CPU; on the card it would hide the kernel, so none is made
        cache_dense = self.device.type == "cpu"
        self.stream_fallback: Optional[str] = None
        if not stream_weights:
            self.stream_fallback = "stream_weights=False"
            self.fallbacks["stream"] = self.stream_fallback
        # sharded: each tensor with a rule packs for the model axis, and
        # this rank keeps its part of it (the rest is freed)
        shards = self.mesh.model if self._spmd else 1
        self.packed: Optional[PackedModel] = (
            pack_model(params, cache_dense=cache_dense, shards=shards)
            if stream_weights else None)
        if self.packed is not None and self._spmd:
            keep_local_tree(self.packed.blocks, self.mesh)
        self.head_sparsity = (sparsity if head_sparsity is None
                              else head_sparsity)
        self.head_fallback: Optional[str] = None
        self.head_shard_fallback: Optional[str] = None
        if bitmap_head:
            self.lm_weight = pack_lm_head(params, cfg, self.head_sparsity,
                                          cache_dense=cache_dense,
                                          shards=shards)
            if (shards > 1 and self.lm_weight is not None
                    and self.lm_weight.shard is None):
                self.head_shard_fallback = (
                    f"shard: vocab={cfg.vocab_size} not divisible by "
                    f"{shards} shards (or no per-shard tile); head "
                    f"stored replicated")
                self._warn_fallback("head_shard", self.head_shard_fallback,
                                    f"bitmap LM head stored replicated: "
                                    f"{self.head_shard_fallback}")
            self.lm_weight = keep_local(self.lm_weight, self.mesh)
            if self.lm_weight is None:
                self.head_fallback = (
                    f"no (BK, BN) tile divides (d_model={cfg.d_model}, "
                    f"vocab={cfg.vocab_size}) with BN % 8 == 0; "
                    f"head served dense")
                self._warn_fallback("head", self.head_fallback,
                                    f"bitmap LM head fell back to dense: "
                                    f"{self.head_fallback}")
        else:
            self.lm_weight = None
            self.head_fallback = "disabled (bitmap_head=False)"
            self.fallbacks["head"] = self.head_fallback
        self.head_compression = (self.lm_weight.compression
                                 if self.lm_weight is not None else 1.0)
        # sharded: the dense params by the reference's specs, this rank's
        # parts kept (pruned and packed whole above, for the global
        # threshold and the packs)
        self.param_specs: Dict[tuple, tuple] = {}
        # baseline mode (``REPRO_PERF_MODE``), read once for every step
        self.baseline = baseline_mode()
        if self._spmd:
            specs = param_specs(cfg, self.mesh, baseline=self.baseline)
            self.param_specs = dict(tree_items(specs))
            self.params = shard_tree(params, specs, self.mesh)
            del params
        self.dense_gather = self._dense_reads()
        self._sync()
        self.pack_s = time.perf_counter() - t0

        self.scheduler = SlotScheduler(num_slots, history=history)
        kvfb = kv_fallbacks(cfg, paged, prefix_reuse, preempt)
        for key, reason in kvfb.items():
            if reason:
                self._warn_fallback(key, reason,
                                    f"{_KV_WARNINGS[key]}: {reason}")
        self.paging_fallback = kvfb["paging"]
        self.prefix_fallback = kvfb["prefix_reuse"]
        self.preempt_fallback = kvfb["preempt"]
        self.page_len = page_len if paged and not self.paging_fallback \
            else 0
        self.prefix_reuse = prefix_reuse and not self.prefix_fallback
        self.preempt = preempt and not self.preempt_fallback
        # data-axis KV sharding: the pools' page ids (and the slots)
        # partition over the mesh's data axis, the data extent unless
        # asked otherwise; a count that cannot hold keeps the pools
        # replicated with the reference's reason
        self.kv_shard_fallback: Optional[str] = None
        ndata = self.mesh.data
        kv_actual = 1
        if self.page_len and self._spmd and ndata > 1:
            want = ndata if kv_shards is None else int(kv_shards)
            if want > 1 and (num_slots % want == 0 and want <= num_slots
                             and want == ndata):
                kv_actual = want
            elif want > 1:
                self.kv_shard_fallback = (
                    f"shard: kv_shards={want} must equal the mesh data "
                    f"axis ({ndata}) and divide num_slots={num_slots}; "
                    f"page pools stored replicated")
                self._warn_fallback("kv_shard", self.kv_shard_fallback,
                                    f"paged KV pools stored replicated: "
                                    f"{self.kv_shard_fallback}")
        self.kv = (PagedKVCache(cfg, num_slots, max_len, self.page_len,
                                pool_tokens=page_pool_tokens,
                                strict=not self.preempt, shards=kv_actual,
                                local_shard=(self.mesh.data_rank
                                             if kv_actual > 1 else None),
                                device=self.device)
                   if self.page_len
                   else SlotKVCache(cfg, num_slots, max_len,
                                    device=self.device))
        self._kv_data_pools = (tuple(self.kv.pools)
                               if self.page_len and kv_actual > 1 else ())
        self.top_k_default = top_k
        self._step_fn = (build_serve_step_spmd(
            cfg, self.mesh, top_k=top_k, data_pools=self._kv_data_pools,
            baseline=self.baseline)
            if self._spmd else build_serve_step(cfg, top_k=top_k,
                                                baseline=self.baseline))
        self.prefill_fallback = (prefill_fallback(cfg) if prefill_chunk > 0
                                 else None)
        if self.prefill_fallback:
            prefill_chunk = 0
            self._warn_fallback("prefill", self.prefill_fallback,
                                f"chunked prefill fell back to "
                                f"teacher-forcing: {self.prefill_fallback}")
        self.prefill_chunk = prefill_chunk
        self.planner: Optional[PrefillPlanner] = (
            PrefillPlanner(num_slots, prefill_chunk) if prefill_chunk
            else None)
        self._prefill_fn = (build_prefill_step_spmd(
            cfg, self.mesh, data_pools=self._kv_data_pools,
            baseline=self.baseline)
            if self._spmd else build_prefill_step(cfg,
                                                  baseline=self.baseline))
        # engine-owned accounting lives in the metrics registry, under
        # the reference's names; the report sections render views of it
        m = self.metrics
        self._c_prefill_steps = m.counter(
            "steps.prefill", help="engine steps that ran a prefill call")
        self._c_decode_steps = m.counter(
            "steps.decode", help="engine steps that ran a decode call")

        self._tok = np.zeros(num_slots, np.int64)
        self._pos = np.zeros(num_slots, np.int64)
        self._temp = np.zeros(num_slots, np.float32)
        self._topk = np.zeros(num_slots, np.int32)
        # each slot's sampling key, ``prng_key`` of its request's seed
        self._keys = np.zeros((num_slots, 2), np.int64)
        self._use_sampling = False
        self._use_topk_vec = False
        self._seed = seed
        # frames frontend: each decode step's embeddings are drawn on the
        # device from this key folded with the step counter on the host
        # (the reference's key, replayed by ``repro_torch.prng``)
        self._embed_key = prng_key(seed + 0x5eed)
        self._warm = False
        self._c_slot_steps = m.counter(
            "steps.active_slots",
            help="decoding slot-steps (occupancy numerator)")
        self._next_rid = 0
        # per-slot ingest = prompt + tokens generated before a
        # preemption: a recomputed request replays its own history
        self._ingest: Dict[int, List[int]] = {}
        self._admit_seq = np.zeros(num_slots, np.int64)  # preempt order
        self._admit_counter = 0
        self._c_recomputed = m.counter(
            "tokens.recomputed",
            help="positions re-ingested after preemption")
        self.history = history
        self.requests: deque = deque(maxlen=max(1, history))
        self._c_done = m.counter("requests.done",
                                 help="requests retired DONE")
        self._c_gen_tokens = m.counter("tokens.generated",
                                       help="tokens delivered by DONE "
                                            "requests")
        self._h_lat = m.histogram("request.latency_s", seed=1,
                                  help="arrival-due -> last token")
        self._h_ftl = m.histogram("request.first_token_s", seed=2,
                                  help="arrival-due -> first token")
        self._h_queue = m.histogram("request.queue_s", seed=3,
                                    help="arrival-due -> slot granted")
        self._h_prefill = m.histogram("request.prefill_s", seed=4,
                                      help="slot granted -> prompt "
                                           "cache resident")
        self._h_fdec = m.histogram("request.first_decode_s", seed=5,
                                   help="prompt resident -> first token")
        self._h_ftl_hit = m.histogram("request.ttft_hit_s", seed=6,
                                      help="TTFT, prefix-cache hits")
        self._h_ftl_miss = m.histogram("request.ttft_miss_s", seed=7,
                                       help="TTFT, prefix-cache misses")

        # ---- lifecycle: deadlines, shedding, bounded preemption, fault
        # injection and invariant auditing ----
        self.deadline_ms = deadline_ms
        self.max_queue = max_queue
        self.ttft_budget_ms = ttft_budget_ms
        self.max_preempts = max_preempts
        self._has_deadlines = deadline_ms is not None
        self._c_cancelled = m.counter("requests.cancelled")
        self._c_expired = m.counter("requests.expired")
        self._c_shed = m.counter("requests.shed")
        self._c_forced_preempts = m.counter(
            "preempts.forced", help="fault-injected forced preemptions")
        self._c_wasted = m.counter(
            "tokens.wasted", help="tokens generated by aborted requests")
        self._step_wall_ema: Optional[float] = None  # TTFT estimator
        self.quarantined: Dict[str, str] = {}
        self.faults = faults
        self.audit = audit
        # checksums are taken here, before any fault can fire: the
        # integrity scans compare against this pristine state
        self.auditor: Optional[InvariantAuditor] = (
            InvariantAuditor(self) if audit else None)

        # ---- traffic ledger: always on (host integer counters in the
        # registry); ``traffic_out`` also writes its artifact at close()
        self.traffic_out = traffic_out
        self._traffic_written = False
        self.traffic = TrafficLedger(self)

        self.scheduler.register_metrics(m)
        self.kv.register_metrics(m)
        self.traffic.register_metrics(m)
        if self.planner is not None:
            self.planner.register_metrics(m)
        if self.packed is not None:
            self.packed.register_metrics(m)
        if self.faults is not None:
            self.faults.register_metrics(m)
        if self.auditor is not None:
            self.auditor.register_metrics(m)
        m.gauge("steps.total", lambda: self._steps,
                help="engine steps taken (includes idle fast-forward)")
        m.gauge("queue.due_depth", self._due_depth,
                help="waiting requests whose arrival has come due")
        self._register_report_views()

    @classmethod
    def from_arch(cls, arch: str, smoke: bool = True, **kw) -> "ServeEngine":
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        return cls(cfg, **kw)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dense_reads(self) -> frozenset:
        """The model-sharded dense leaves the step reads, which it
        gathers: every block leaf with no packed form (all of them with
        ``stream_weights=False``; a quarantined leaf loses its packed
        form), and the head's dense source when the head is served from
        the params.  Empty on one rank."""
        if not self._spmd:
            return frozenset()
        head = self.lm_weight is None
        out = set()
        for path, _ in tree_items(self.params):
            if not sharded_on(self.param_specs[path], "model", self.mesh):
                continue
            if path[0] == "blocks":
                bname, comp, name = path[1:]
                if (self.packed is None or
                        self.packed.blocks[bname][comp][name] is None):
                    out.add(path)
            elif head and path == (("embed",) if self.cfg.tie_embeddings
                                   else ("lm_head",)):
                out.add(path)
        return frozenset(out)

    def dense_numel(self, path: tuple) -> int:
        """Elements of a params leaf's whole tensor (a sharded rank
        holds a part of it)."""
        return math.prod(self.dense_shapes[path])

    def resident_dense_bytes(self) -> int:
        """The dense params' bytes this rank holds."""
        return resident_bytes(self.params)

    def _warn_fallback(self, key: str, reason: str, message: str) -> None:
        """Record a fallback reason (mirrored into ``report()``) and warn
        it once per (key, reason) per engine."""
        self.fallbacks[key] = reason
        if (key, reason) not in self._warned:
            self._warned.add((key, reason))
            self._emit("fallback", key=key, reason=reason)
            warnings.warn(message, stacklevel=3)

    @property
    def decode_steps(self) -> int:
        """Engine steps that ran a decode call (registry counter)."""
        return self._c_decode_steps.value

    @property
    def prefill_steps(self) -> int:
        """Engine steps that ran a prefill call (registry counter)."""
        return self._c_prefill_steps.value

    # --------------------------------------------------------- telemetry ----

    @property
    def _forced_preempts(self) -> int:
        """Fault-injected forced-preemption count (registry counter)."""
        return self._c_forced_preempts.value

    def _emit(self, kind: str, rid: Optional[int] = None,
              **fields) -> None:
        """Append to the event log (a no-op, one ``is None`` check, with
        telemetry off)."""
        if self.events is not None:
            self.events.emit(kind, t=self._clock.now_or_zero(),
                             step=self._steps, rid=rid, **fields)

    def close(self) -> List[str]:
        """Write the configured artifacts (trace, events, metrics,
        traffic); idempotent, returns the paths written."""
        written: List[str] = []
        if self.traffic_out and not self._traffic_written:
            self._traffic_written = True
            d = os.path.dirname(self.traffic_out)
            if d:
                os.makedirs(d, exist_ok=True)
            self.traffic.write(self.traffic_out)
            written.append(self.traffic_out)
        if self.telemetry is not None:
            written.extend(self.telemetry.close())
        return written

    def _trace_counter(self, name: str, values: Dict[str, int]) -> None:
        """One Chrome-trace counter sample (the per-phase HBM byte
        tracks); a no-op without ``trace_out``."""
        if self.telemetry is None or self.telemetry.trace is None:
            return
        self.telemetry.trace.counter(name, self._clock.now_or_zero(),
                                     values)

    def _register_report_views(self) -> None:
        """``report()``'s top-level fields and sections as registry
        views, in the reference's key order."""
        m = self.metrics
        m.view("requests", lambda: self._c_done.value)
        m.view("retained_requests", lambda: len(self.requests))
        m.view("generated_tokens", lambda: self._c_gen_tokens.value)
        m.view("steps", lambda: self._steps)
        m.view("wall_s", lambda: (self._clock.now()
                                  if self._clock.started else 0.0))

        def tok_per_s():
            dt = self._clock.now() if self._clock.started else 0.0
            gen = self._c_gen_tokens.value
            return gen / dt if dt > 0 else float("nan")

        m.view("tok_per_s", tok_per_s)
        m.view("latency_s", self._h_lat.percentiles)
        m.view("first_token_s", self._h_ftl.percentiles)
        m.view("ttft", lambda: {
            "queue_s": self._h_queue.percentiles(),
            "prefill_s": self._h_prefill.percentiles(),
            "first_decode_s": self._h_fdec.percentiles(),
        })
        m.view("prefill", self.prefill_report)
        m.view("prefix_reuse", self.prefix_reuse_report)
        m.view("slot_occupancy",
               lambda: (self._c_slot_steps.value
                        / (self._steps * self.num_slots)
                        if self._steps else 0.0))
        m.view("weight_sparsity", lambda: self.weight_sparsity)
        m.view("head_compression", lambda: self.head_compression)
        m.view("head_fallback", lambda: self.head_fallback)
        m.view("weight_stream", self.weight_stream_report)
        m.view("traffic", self.traffic.report)
        m.view("paging", self.paging_report)
        m.view("cache_resets", lambda: self.kv.resets)
        m.view("lifecycle", self.lifecycle_report)
        m.view("fallbacks", lambda: dict(self.fallbacks))

    # ------------------------------------------------------------ intake ----

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               arrival: float = 0.0, temperature: float = 0.0,
               seed: Optional[int] = None,
               top_k: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> Request:
        """Queue one request.  ``temperature`` > 0 samples its tokens
        from its own stream, seeded by ``seed`` (default: from the engine
        seed and the rid); ``top_k`` truncates its sampling (None: the
        engine default; 0: none); ``deadline_ms`` overrides the engine's
        latency budget for it.  Raises ``RequestRejected`` when the
        request can never run: empty prompt, a budget below one token,
        prompt + budget beyond ``max_len``, or, paged, a worst-case page
        need larger than the whole pool.  Raises ``ServeOverloaded`` when
        the request is due now and admission control is shedding; a
        future arrival is checked again when it comes due."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise RequestRejected("empty prompt")
        if max_new_tokens < 1:
            raise RequestRejected(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        need = len(prompt) + max_new_tokens - 1
        if need > self.max_len:
            raise RequestRejected(
                f"prompt {len(prompt)} + {max_new_tokens} new tokens "
                f"exceeds max_len {self.max_len}")
        if self.page_len and not self.kv.possible(need):
            raise RequestRejected(
                f"prompt {len(prompt)} + {max_new_tokens} new tokens needs "
                f"more pages than the whole pool holds "
                f"(page_len={self.page_len}); raise page_pool_tokens")
        if any(not 0 <= t < self.cfg.vocab_size for t in prompt):
            raise RequestRejected(
                f"prompt token outside the vocabulary "
                f"[0, {self.cfg.vocab_size})")
        if arrival <= self._steps:
            reason = self._overload_reason()
            if reason is not None:
                self._c_shed.inc()
                self._emit("shed", reason=reason, at="submit")
                raise ServeOverloaded(
                    reason, queue_depth=self._due_depth(),
                    est_ttft_s=self.estimated_ttft_s())
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, arrival=arrival,
                      temperature=temperature, seed=seed, top_k=top_k,
                      deadline_ms=(deadline_ms if deadline_ms is not None
                                   else self.deadline_ms))
        if req.deadline_ms is not None:
            self._has_deadlines = True
        if temperature > 0:
            self._use_sampling = True
        if top_k is not None and top_k != self.top_k_default:
            self._use_topk_vec = True
        self._next_rid += 1
        self.scheduler.submit(req)
        self._emit("submit", rid=req.rid, prompt_tokens=len(prompt),
                   max_new_tokens=max_new_tokens, arrival=arrival)
        return req

    # --------------------------------------------------------- lifecycle ----

    def cancel(self, rid: int) -> bool:
        """Cancel a request by rid at any stage: queued (a preempted
        request waiting to replay included), mid-prefill or mid-decode.
        Its pages and prefix-cache references are released; its partial
        tokens stay on the request (CANCELLED, no error).  Returns False
        for an unknown or already finished rid."""
        for r in self.scheduler.waiting:
            if r.rid == rid:
                self.scheduler.cancel_waiting(r)
                r.transition(RequestState.CANCELLED)
                self._abort(r, RequestState.CANCELLED)
                return True
        for slot, r in list(self.scheduler.active.items()):
            if r.rid == rid:
                req = self._release_slot(slot, RequestState.CANCELLED)
                self._abort(req, RequestState.CANCELLED)
                return True
        return False

    def _release_slot(self, slot: int, state: RequestState) -> Request:
        """Tear a slot down into any terminal state: planner job, pages,
        ingest and sampling lanes all released."""
        if self.planner is not None:
            self.planner.cancel(slot)
        req = self.scheduler.release(slot, state=state)
        if self.page_len:
            self.kv.retire(slot)
        self._ingest.pop(slot, None)
        self._pos[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        return req

    def _abort(self, req: Request, state: RequestState,
               error: Optional[Exception] = None) -> None:
        """Terminal bookkeeping for the outcomes other than DONE."""
        req.error = error
        req.done_step = self._steps
        if self._clock.started:
            req.t_done = self._wall()
        if state is RequestState.CANCELLED:
            self._c_cancelled.inc()
        elif state is RequestState.EXPIRED:
            self._c_expired.inc()
        elif state is RequestState.SHED:
            self._c_shed.inc()
        self._c_wasted.inc(len(req.tokens))
        self.requests.append(req)
        self._emit(state.name.lower(), rid=req.rid,
                   tokens=len(req.tokens),
                   reason=str(error) if error is not None else None)
        if self.telemetry is not None:
            self.telemetry.request_done(req)

    def _due_depth(self) -> int:
        """Waiting requests whose arrival has come due."""
        return sum(1 for r in self.scheduler.waiting
                   if r.arrival <= self._steps)

    def estimated_ttft_s(self) -> Optional[float]:
        """Queue-drain TTFT estimate for a request arriving now: the
        outstanding tokens (due queue and live remainders) spread over
        the slots, at the per-step wall's moving average.  None until a
        step has been timed."""
        if self._step_wall_ema is None:
            return None
        work = 0
        for r in self.scheduler.waiting:
            if r.arrival <= self._steps:
                work += len(r.prompt) + r.max_new_tokens - 1
        for slot, r in self.scheduler.active.items():
            total = len(r.prompt) + r.max_new_tokens - 1
            work += max(0, total - int(self._pos[slot]))
        return (work / self.num_slots) * self._step_wall_ema

    def _overload_reason(self, exclude_self: bool = False) -> Optional[str]:
        """Why admission control refuses a request due now, or None.
        ``exclude_self``: the step-start sweep judges a request already
        in the queue, which must not count toward its own depth."""
        depth = self._due_depth() - (1 if exclude_self else 0)
        if self.max_queue is not None and depth >= self.max_queue:
            return f"queue depth {depth} >= max_queue {self.max_queue}"
        if self.ttft_budget_ms is not None:
            est = self.estimated_ttft_s()
            if est is not None and est * 1e3 > self.ttft_budget_ms:
                return (f"estimated TTFT {est * 1e3:.1f}ms > budget "
                        f"{self.ttft_budget_ms:.1f}ms")
        return None

    def _deadline_passed(self, req: Request, wall: float) -> bool:
        return (req.deadline_ms is not None and req.t_due is not None
                and (wall - req.t_due) * 1e3 > req.deadline_ms)

    def _pinned(self, slot: int) -> bool:
        """A slot whose request used up its preemption budget: it holds
        a worst-case commitment and is never chosen as a victim."""
        req = self.scheduler.active.get(slot)
        return (req is not None
                and len(req.t_preempt) >= self.max_preempts)

    # ------------------------------------------------------------- loop ----

    def _wall(self) -> float:
        """The wall clock decisions read: this process's clock on one
        rank; in a sharded world the step's reading of rank 0's."""
        if self._spmd and self._now is not None:
            return self._now
        return self._clock.now()

    def _tick(self) -> None:
        """A sharded world's one clock reading per step, rank 0's,
        broadcast, and the TTFT estimate's step time from two such
        readings (every rank's estimate is then the same)."""
        self._now = self.mesh.from_root([self._clock.now()])[0]
        if self._last_now is not None:
            self._observe_step(self._now - self._last_now)
        self._last_now = self._now

    def _observe_step(self, dt: float) -> None:
        self._step_wall_ema = (dt if self._step_wall_ema is None
                               else 0.8 * self._step_wall_ema + 0.2 * dt)

    def _commit_tokens(self, req: Request) -> int:
        """Pages to commit at admission, in tokens: the worst case
        (prompt + budget) in strict mode and for pinned requests, the
        live ingest (prompt + tokens generated before a preemption) in
        preemptible mode."""
        if self.preempt and len(req.t_preempt) < self.max_preempts:
            return len(req.prompt) + len(req.tokens)
        return len(req.prompt) + req.max_new_tokens - 1

    def _with_pages(self, fn, requester: int):
        """Run a page-mapping call, answering ``OutOfPages`` (raised only
        in preemptible mode, after the prefix cache is drained) by
        preempting the youngest other slot until it succeeds."""
        while True:
            try:
                return fn()
            except OutOfPages:
                self._reclaim(requester)

    def _reclaim(self, requester: int) -> None:
        # sharded pools: only a victim of the requester's shard frees
        # pages it can use (the shards' page ranges are disjoint)
        d = self.kv.slot_shard(requester)
        victims = [s for s in self.scheduler.active
                   if s != requester and not self._pinned(s)
                   and self.kv.slot_shard(s) == d]
        if not victims and self.kv.restore_held():
            # confiscated headroom and no one left to preempt: hand the
            # pages back rather than deadlock the last request
            return
        # unreachable by construction: submit checks possible(), a lone
        # slot never exceeds its capped worst case, and pinned slots
        # hold worst-case commitments
        assert victims, "page pool exhausted with no preemptable slot"
        self._preempt_slot(max(victims,
                               key=lambda s: int(self._admit_seq[s])))

    def _preempt_slot(self, slot: int) -> None:
        """Reclaim the slot's pages and re-queue its request at the head
        of the line.  On re-admission the prompt and the tokens already
        generated re-ingest through the normal path; sampling noise
        depends on (seed, position) only, so the recomputed stream is
        the undisturbed one."""
        req = self.scheduler.active[slot]
        req.t_preempt.append(self._wall())
        self._emit("preempt", rid=req.rid, slot=slot,
                   tokens=len(req.tokens))
        if self.planner is not None:
            self.planner.cancel(slot)
        self.scheduler.requeue(slot)
        if self.page_len:
            self.kv.retire(slot)
        self._ingest.pop(slot, None)
        self._pos[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0

    def _retire(self, req: Request) -> None:
        """Fold a finished request into the aggregates and the retained
        history."""
        self._c_done.inc()
        self._c_gen_tokens.inc(len(req.tokens))
        self._h_lat.observe(req.latency_s)
        self._h_ftl.observe(req.first_token_s)
        self._h_queue.observe(req.queue_s)
        self._h_prefill.observe(req.prefill_s)
        self._h_fdec.observe(req.first_decode_s)
        (self._h_ftl_hit if req.prefix_hit_tokens > 0
         else self._h_ftl_miss).observe(req.first_token_s)
        self.requests.append(req)
        self._emit("done", rid=req.rid, tokens=len(req.tokens),
                   latency_s=req.latency_s)
        if self.telemetry is not None:
            self.telemetry.request_done(req)

    def _recover_corruption(self, logits: Optional[torch.Tensor],
                            decoding: List[int]) -> bool:
        """Integrity scan, quarantine and replay (the ``audit=True``
        corruption path).  Returns True when corruption was found: the
        caller then discards the step's results.

        Every packed tensor (stack leaves and LM head) is checksummed
        against its pack-time CRC and checked for non-finite values.
        Each corrupted tensor is quarantined: a stack leaf becomes None
        (``matmul_or_bitmap`` multiplies by the dense params tensor,
        which global pruning already left equal to the pack), the head
        is served from the params' head as it stands, as the reference
        serves it; the reason lands in the manifest.  Then the prefix
        cache is flushed (its pages may hold KV lines written through the
        corrupt path) and every active slot is preempted, so all
        in-flight requests replay through the clean path.  Non-finite logits with no
        corrupted tensor to blame raise ``AuditViolation``: that is a
        bug, not a recoverable fault."""
        bad = self.auditor.integrity_scan()
        if not bad:
            if logits is not None:
                self.auditor.check_logits(logits.float().cpu().numpy(),
                                          decoding)
            return False
        for path in bad:
            reason = ("quarantined: integrity checksum mismatch "
                      "(served dense from pristine params)")
            if path == "lm_head":
                self.lm_weight = None
                self.head_fallback = reason
                self.head_compression = 1.0
                self._warn_fallback(
                    "head", reason,
                    "bitmap LM head quarantined to dense: corrupted "
                    "value/bitmap payload detected")
            else:
                self.packed.quarantine(path, reason)
                self._warn_fallback(
                    f"quarantine:{path}", reason,
                    f"packed tensor {path} quarantined to dense: "
                    f"corrupted value/bitmap payload detected")
            self.quarantined[path] = reason
            self.auditor.drop(path)
            self._emit("quarantine", tensor=path, reason=reason)
        # a quarantine flips manifest entries to dense: the ledger's
        # cached role rows are stale now, and the step reads the leaves
        # from the (gathered) params
        self.traffic.invalidate()
        self.dense_gather = self._dense_reads()
        if self.page_len:
            self.kv.flush_prefix()
        for slot in list(self.scheduler.active):
            self._preempt_slot(slot)
        return True

    def decode_args(self):
        """(args, kwargs) of the next decode step's call, assembled from
        the engine's host state (the traffic ledger's cross-check counts
        the step on meta copies of them)."""
        tok = torch.from_numpy(self._tok[:, None]).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        packed = self.packed.blocks if self.packed is not None else None
        kw = dict(lm_weight=self.lm_weight, packed=packed)
        if self.page_len:
            kw["page_tables"] = self.kv.tables()
        if self._use_sampling:
            kw.update(sample_keys=torch.from_numpy(self._keys).to(
                self.device), temperature=torch.from_numpy(
                    self._temp).to(self.device))
            if self._use_topk_vec:
                kw["top_ks"] = torch.from_numpy(self._topk).to(self.device)
        if self._spmd:
            kw["dense"] = self.dense_gather
        if self.cfg.frontend == "frames":
            # the step draws its frame embeddings from the key folded with
            # the step counter; no token is looked up
            kw["embed_key"] = fold_in(self._embed_key, self._steps)
            tok = None
        return (self.params, self.kv.cache, tok, pos), kw

    def _decode(self):
        args, kw = self.decode_args()
        return self._step_fn(*args, **kw)

    def prefill_args(self, tokens: np.ndarray, pos: np.ndarray,
                     lens: np.ndarray):
        """(args, kwargs) of a chunked-prefill call over the fixed
        (num_slots, C) batch."""
        packed = self.packed.blocks if self.packed is not None else None
        kw = {"dense": self.dense_gather} if self._spmd else {}
        return ((self.params, self.kv.cache,
                 torch.from_numpy(tokens).to(self.device, torch.int64),
                 torch.from_numpy(pos).to(self.device, torch.int64),
                 torch.from_numpy(lens).to(self.device, torch.int64)),
                dict(packed=packed,
                     page_tables=self.kv.tables() if self.page_len else None,
                     **kw))

    def _prefill(self, tokens: np.ndarray, pos: np.ndarray,
                 lens: np.ndarray):
        """One chunked-prefill call over the fixed (num_slots, C) batch."""
        args, kw = self.prefill_args(tokens, pos, lens)
        return self._prefill_fn(*args, **kw)

    def _prefill_call(self) -> None:
        """Run the planner's next batched chunk call and route results:
        slots whose last chunk this was flip to decode at position
        ``len(prompt) - 1`` (the next decode step consumes the last
        prompt token and samples the first generated one, as the walk's
        last prompt step does); slots still mid-prefill park their
        passenger decode write on their next unwritten position, which
        the next chunk rewrites before anything reads it.

        Paged, every lane's chunk pages are mapped first, oldest slot
        first: a dry pool in preemptible mode preempts the youngest,
        which have not mapped yet (a preempted lane still writes, into
        the trash page).  Each advanced slot's fully written blocks are
        published right after the call, before a later chunk's ring can
        wrap over them."""
        tokens, pos, lens, finished = self.planner.next_call()
        if self.page_len:
            for slot in sorted((int(s) for s in np.nonzero(lens)[0]),
                               key=lambda s: int(self._admit_seq[s])):
                if slot in self.scheduler.active:
                    self._with_pages(
                        lambda s=slot: self.kv.ensure_range(
                            s, int(pos[s]), int(pos[s]) + int(lens[s])),
                        slot)
        self._prefill(tokens, pos, lens)
        self._trace_counter("hbm.prefill",
                            self.traffic.on_prefill(pos, lens))
        self._sync()
        wall = self._wall()
        if self.prefix_reuse:
            for slot in np.nonzero(lens)[0]:
                if int(slot) in self.scheduler.active:
                    self.kv.register_prefix(
                        int(slot), self._ingest[int(slot)],
                        int(pos[slot]) + int(lens[slot]))
        for slot in finished:
            if slot not in self.scheduler.active:
                continue               # preempted while mapping
            req = self.scheduler.active[slot]
            ing = self._ingest[slot]
            self._pos[slot] = len(ing) - 1
            self._tok[slot] = ing[-1]
            if req.t_prefill_done is None:
                req.t_prefill_done = wall
                self._emit("prefill_done", rid=req.rid, slot=slot)
        for slot in np.nonzero(lens)[0]:
            if self.planner.in_prefill(int(slot)):
                self._pos[slot] = self.planner.next_pos(int(slot))
        self._c_prefill_steps.inc()

    def warmup(self) -> None:
        """Run one throwaway decode step (and, with chunked prefill, one
        prefill call with every lane masked, which writes nothing) before
        the latency clock starts, so the first request's latency does not
        include building the kernel library.  Slots are all idle here;
        whatever the decode step writes at position 0 is zeroed on
        admission (paged: every table is unmapped, so it all lands on
        the trash page)."""
        if self._warm:
            return
        nxt, _, _ = self._decode()
        nxt.cpu()
        if self.prefill_chunk:
            zeros = np.zeros(self.num_slots, np.int64)
            self._prefill(np.zeros((self.num_slots, self.prefill_chunk),
                                   np.int64), zeros, zeros)
            self._sync()
        self._warm = True

    def step(self) -> None:
        """One engine step: fire the fault plan, expire and shed due
        requests, admit into free slots, run at most one chunked-prefill
        call, then the full-batch decode step and its tokens' routing
        (skipped when every active slot is mid-prefill), the mid-flight
        deadline sweep and the audit.

        With telemetry on, every host-side stretch of the step sits in
        exactly one phase span (``telemetry.PHASES``): schedule →
        [prefill] → [page_ensure → decode → host_sync → sample] →
        [deadline_sweep] → [audit].  The decode phase ends when the step
        is enqueued; device time surfaces in ``host_sync``, the copy of
        the step's tokens to the host.  Telemetry off: ``sp is None``
        and every bracket is a dead branch."""
        self.warmup()
        self._clock.start()
        if self._spmd:
            self._tick()
        sp = self.spans
        t_begin = time.perf_counter()
        if sp is not None:
            sp.step_begin(self._steps, t_begin)
            sp.begin("schedule")
        now = float(self._steps)
        if self.faults is not None:
            n_log = len(self.faults.log)
            self.faults.fire(self, self._steps)
            if self.events is not None:
                for entry in list(self.faults.log)[n_log:]:
                    self._emit("fault", kind_detail=entry.get("kind"),
                               fired=bool(entry.get("fired")),
                               tensor=entry.get("tensor"))
        shedding = (self.max_queue is not None
                    or self.ttft_budget_ms is not None)
        for r in list(self.scheduler.waiting):
            if r.arrival <= now and r.t_due is None:
                r.t_due = self._wall()
                if shedding:
                    reason = self._overload_reason(exclude_self=True)
                    if reason is not None:
                        # came due while overloaded: shed with the typed
                        # error recorded (submit raised for requests due
                        # when they were submitted)
                        self.scheduler.cancel_waiting(r)
                        r.transition(RequestState.SHED)
                        self._abort(r, RequestState.SHED,
                                    error=ServeOverloaded(
                                        reason,
                                        queue_depth=self._due_depth()))
                        continue
            if self._has_deadlines and self._deadline_passed(
                    r, self._wall()):
                self.scheduler.cancel_waiting(r)
                r.transition(RequestState.EXPIRED)
                self._abort(r, RequestState.EXPIRED,
                            error=DeadlineExceeded(
                                f"rid {r.rid}: queued past its "
                                f"{r.deadline_ms:.0f}ms deadline"))
        # paged: the head-of-line request reserves its pages (check and
        # commit) or queues, strictly FIFO, until retirements free them.
        # The reservation lands in the shard of the slot it will get:
        # admit asks ``fits`` before it pops the first free slot
        fits = ((lambda r: self.kv.reserve(
            self._commit_tokens(r),
            slot=(self.scheduler.free[0] if self.scheduler.free else 0)))
            if self.page_len else None)
        for slot, req in self.scheduler.admit(now, fits=fits):
            # a re-admitted request ingests its generated tokens too
            ing = list(req.prompt) + list(req.tokens)
            self._admit_seq[slot] = self._admit_counter
            self._admit_counter += 1
            shared = 0
            if self.page_len:
                blocks = (self.kv.match_prefix(ing, slot=slot)[1]
                          if self.prefix_reuse else None)
                shared = self.kv.admit(slot, self._commit_tokens(req),
                                       prefix=blocks)
            else:
                self.kv.reset_slot(slot)
            self._ingest[slot] = ing
            if not req.t_preempt:
                req.prefix_hit_tokens = shared
            else:
                # the recompute this re-admission pays (adopted blocks,
                # often its own earlier registrations, shrink it)
                req.recomputed_tokens += max(0, len(ing) - 1 - shared)
                self._c_recomputed.inc(max(0, len(ing) - 1 - shared))
            self._pos[slot] = shared
            self._tok[slot] = ing[shared]
            self._temp[slot] = req.temperature
            self._topk[slot] = (req.top_k if req.top_k is not None
                                else self.top_k_default)
            rseed = (req.seed if req.seed is not None
                     else self._seed + 0x9e37 * (req.rid + 1))
            self._keys[slot] = prng_key(rseed)
            req.admit_step = self._steps
            if req.t_due is None:
                req.t_due = self._wall()
            if req.t_admit is None:   # a re-admission keeps the first
                req.t_admit = self._wall()
            if self.planner is not None:
                self.planner.start(slot, ing, start=shared)
            if shared >= len(ing) - 1 and req.t_prefill_done is None:
                # nothing to ingest: a one-token prompt or a full hit
                req.t_prefill_done = req.t_admit
            self._emit("admit", rid=req.rid, slot=slot,
                       prefix_hit_tokens=shared)
        if sp is not None:
            sp.end()

        # at most one prefill call per engine step: long prompts
        # interleave chunk calls with decode steps, never starve them
        prefilled = False
        if self.planner is not None and self.planner.has_work:
            if sp is not None:
                sp.begin("prefill")
            self._prefill_call()
            if sp is not None:
                sp.end()
            prefilled = True
        in_prefill = (self.planner.in_prefill if self.planner is not None
                      else lambda s: False)
        decoding = [s for s in self.scheduler.active if not in_prefill(s)]
        if decoding or not prefilled:
            if self.page_len:
                # map each decoding slot's write page, oldest first (a
                # dry pool preempts the youngest, which have not mapped
                # yet); mid-prefill passengers stay unmapped
                if sp is not None:
                    sp.begin("page_ensure")
                for slot in sorted(decoding,
                                   key=lambda s: int(self._admit_seq[s])):
                    if slot in self.scheduler.active:
                        self._with_pages(
                            lambda s=slot: self.kv.ensure(
                                s, int(self._pos[s])), slot)
                decoding = [s for s in self.scheduler.active
                            if not in_prefill(s)]
                if sp is not None:
                    sp.end()
            self._decode_and_route(decoding, in_prefill, sp)
        elif self.audit:
            # prefill-only step: no logits to check, but a fault may
            # have corrupted tensors the prefill call just read
            if sp is not None:
                sp.begin("audit")
            self._recover_corruption(None, [])
            if sp is not None:
                sp.end()
        if self._has_deadlines:
            if sp is not None:
                sp.begin("deadline_sweep")
            wall = self._wall()
            for slot in list(self.scheduler.active):
                req = self.scheduler.active[slot]
                if self._deadline_passed(req, wall):
                    self._release_slot(slot, RequestState.EXPIRED)
                    self._abort(req, RequestState.EXPIRED,
                                error=DeadlineExceeded(
                                    f"rid {req.rid}: exceeded its "
                                    f"{req.deadline_ms:.0f}ms deadline "
                                    f"mid-flight"))
            if sp is not None:
                sp.end()
        if self.auditor is not None:
            if sp is not None:
                sp.begin("audit")
            try:
                self.auditor.check_step()
            except Exception as e:
                self._emit("audit_violation", reason=str(e))
                raise
            if sp is not None:
                sp.end()
        dt = time.perf_counter() - t_begin
        if sp is not None:
            sp.step_end()
        if not self._spmd:
            self._observe_step(dt)
        self._steps += 1

    def _decode_and_route(self, decoding: List[int], in_prefill,
                          sp) -> None:
        """The full-batch decode step (mid-prefill slots ride along as
        passengers whose output is dropped) and its tokens' routing; a
        filled block is published to the prefix cache, generated blocks
        included.  Under audit a corrupted tensor discards the step
        (``_recover_corruption``): every request replays through the
        quarantined path instead."""
        self._trace_counter("hbm.decode", self.traffic.on_decode(
            [int(self._pos[s]) for s in decoding]))
        if sp is not None:
            sp.begin("decode")
        nxt, logits, _ = self._decode()
        if sp is not None:
            sp.end()
            sp.begin("host_sync")
        nxt_host = nxt.cpu().numpy()
        if sp is not None:
            sp.end()
        wall = self._wall()
        if sp is not None:
            sp.begin("sample")
        if not (self.audit and self._recover_corruption(logits, decoding)):
            self._route(decoding, in_prefill, nxt_host, wall)
        if sp is not None:
            sp.end()
        self._c_decode_steps.inc()

    def _route(self, decoding: List[int], in_prefill, nxt_host: np.ndarray,
               wall: float) -> None:
        """Commit one decode step's results: advance every decoding slot,
        teacher-force the prompt (or a preempted request's history), or
        append the sampled token and retire finished requests."""
        self._c_slot_steps.inc(len(decoding))
        for slot, req in list(self.scheduler.active.items()):
            if in_prefill(slot):
                continue
            ing = self._ingest[slot]
            p = int(self._pos[slot])
            self._pos[slot] = p + 1
            if self.prefix_reuse and (p + 1) % self.page_len == 0:
                self.kv.register_prefix(slot, ing, p + 1)
            if p + 1 < len(ing):
                # still consuming the prompt (or a preempted request's
                # history): teacher-force its next token
                self._tok[slot] = ing[p + 1]
                if p + 1 == len(ing) - 1 and req.t_prefill_done is None:
                    req.t_prefill_done = wall     # prompt cache resident
                    self._emit("prefill_done", rid=req.rid, slot=slot)
                continue
            t = int(nxt_host[slot])
            req.tokens.append(t)
            ing.append(t)
            if req.t_first is None:
                req.t_first = wall
                if self.events is not None:
                    self._emit("first_token", rid=req.rid, slot=slot)
            self._tok[slot] = t
            if (len(req.tokens) >= req.max_new_tokens
                    or p + 1 >= self.max_len):
                req.t_done = wall
                req.done_step = self._steps
                self._release_slot(slot, RequestState.DONE)
                self._retire(req)

    def run(self) -> dict:
        """Drive until every submitted request has drained; report."""
        self.warmup()
        self._clock.start()
        while self.scheduler.has_work:
            if not self.scheduler.active:
                # idle: fast-forward the step clock to the next arrival
                nxt = self.scheduler.next_arrival()
                if nxt > self._steps:
                    self._steps = int(math.ceil(nxt))
            self.step()
        return self.report()

    # ---------------------------------------------------------- reports ----

    def weight_stream_report(self) -> dict:
        """Modeled per-step weight bytes, sparse vs dense, across the
        decode stack and the LM head (the embedding lookup gathers B rows
        and is not counted)."""
        head_dense = self.cfg.d_model * self.cfg.vocab_size * 4
        head_sparse = (self.lm_weight.hbm_bytes
                       if self.lm_weight is not None else head_dense)
        head_sh = (self.lm_weight.shard[1]
                   if self.lm_weight is not None
                   and self.lm_weight.shard is not None else 1)
        # a step touches at most min(E, num_slots × top_k) experts: the
        # modeled (gather-dispatch) figure; the capacity dispatch executes
        # all E
        activated = (self.num_slots * self.cfg.top_k
                     if self.cfg.num_experts else None)
        if self.packed is not None:
            rep = self.packed.stream_report(activated_experts=activated)
        else:
            dense = 0
            for bname, bd in self.params["blocks"].items():
                for comp, tensors in bd.items():
                    for name, t in tensors.items():
                        path = ("blocks", bname, comp, name)
                        shape = self.dense_shapes[path]
                        routed = (shape[1] if (comp, name) in ROUTED_EXPERT
                                  and len(shape) == 4 else 0)
                        dense += int(round(self.dense_numel(path)
                                           * t.element_size()
                                           * activated_scale(routed,
                                                             activated)))
            rep = {"sparse_bytes_per_step": dense,
                   "dense_bytes_per_step": dense, "reduction": 1.0,
                   "packed_tensors": 0, "fallback_tensors": 0,
                   "activated_experts": activated,
                   "fallbacks": {"*": self.stream_fallback
                                 or "stream_weights=False"},
                   "shards": 1,
                   "device_sparse_bytes_per_step": dense,
                   "device_dense_bytes_per_step": dense,
                   "shard_fallbacks": {}}
        sparse = rep["sparse_bytes_per_step"] + head_sparse
        dense = rep["dense_bytes_per_step"] + head_dense
        # one rank's terms: a sharded head streams 1/S of its packed
        # bytes per rank; the dense head (and a replicated packed one)
        # is resident, and streamed, whole on every rank
        shard_fb = dict(rep["shard_fallbacks"])
        if self.head_shard_fallback:
            shard_fb["lm_head"] = self.head_shard_fallback
        return {**rep, "sparse_bytes_per_step": sparse,
                "dense_bytes_per_step": dense,
                "reduction": dense / sparse if sparse else 1.0,
                "device_sparse_bytes_per_step": (
                    rep["device_sparse_bytes_per_step"]
                    + head_sparse // head_sh),
                "device_dense_bytes_per_step": (
                    rep["device_dense_bytes_per_step"] + head_dense),
                "shard_fallbacks": shard_fb}

    def prefill_report(self) -> dict:
        """The prefill section: chunk-call accounting and the step split."""
        rep = {"enabled": self.prefill_chunk > 0,
               "fallback": self.prefill_fallback,
               "prefill_steps": self.prefill_steps,
               "decode_steps": self.decode_steps}
        if self.planner is not None:
            rep.update(self.planner.report())
        else:
            rep.update({"chunk": 0, "calls": 0, "tokens_prefilled": 0,
                        "in_flight": 0, "lane_utilization": None})
        return rep

    def prefix_reuse_report(self) -> dict:
        """Shared-prefix and preemption counters: the cache's hits,
        evictions and forks, the hit / miss TTFT split and the
        recompute the preemptions cost."""
        rep = {
            "enabled": self.prefix_reuse,
            "fallback": self.prefix_fallback,
            "ttft_hit_s": self._h_ftl_hit.percentiles(),
            "ttft_miss_s": self._h_ftl_miss.percentiles(),
            "hit_requests": self._h_ftl_hit.count,
            "miss_requests": self._h_ftl_miss.count,
            "preempt": {
                "enabled": self.preempt,
                "fallback": self.preempt_fallback,
                "count": self.scheduler.preemptions,
                "recomputed_tokens": self._c_recomputed.value,
            },
        }
        if self.page_len:
            rep.update(self.kv.prefix_report())
        return rep

    def lifecycle_report(self) -> dict:
        """Terminal-state taxonomy and the overload and fault accounting.
        Every retired request lands in exactly one terminal state (DONE,
        CANCELLED, EXPIRED, SHED); ``shed`` also counts submit-time
        refusals, which leave no request behind."""
        by_state: Dict[str, int] = {}
        for req in self.requests:
            by_state[req.state.name] = by_state.get(req.state.name, 0) + 1
        rep = {
            "deadline_ms": self.deadline_ms,
            "max_queue": self.max_queue,
            "ttft_budget_ms": self.ttft_budget_ms,
            "max_preempts": self.max_preempts,
            "cancelled": self._c_cancelled.value,
            "expired": self._c_expired.value,
            "shed": self._c_shed.value,
            "forced_preempts": self._forced_preempts,
            "wasted_tokens": self._c_wasted.value,
            "estimated_ttft_s": self.estimated_ttft_s(),
            "terminal_states": by_state,
            "quarantined": dict(self.quarantined),
        }
        if self.faults is not None:
            rep["faults"] = self.faults.summary()
        if self.auditor is not None:
            rep["audit"] = self.auditor.report()
        return rep

    def paging_report(self) -> dict:
        """Pool accounting when paged; the contiguous reservation when
        not."""
        if self.page_len:
            positions = [int(self._pos[s]) for s in self.scheduler.active]
            return {"paged": True, "fallback": None,
                    **self.kv.report(positions)}
        reserved = self.kv.reserved_kv_bytes()
        return {"paged": False, "fallback": self.paging_fallback,
                "reserved_kv_bytes": reserved,
                "contiguous_kv_bytes": reserved,
                "reserved_reduction": 1.0}

    def report(self) -> dict:
        """Serving statistics: a rendered snapshot of the metrics
        registry, with the reference's keys in the reference's order."""
        return self.metrics.render()

"""Continuous-batching serving engine over the packed decode stack.

Port of the core of ``repro/serve/engine.py``:

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
  attention and MLP projection and the head go through
  ``kernels/ops.bitmap_spmm`` on every decode step, and every MoE
  expert stack through ``kernels/ops.bitmap_spmm_grouped`` — on the
  card, the hand-written CUDA kernels;
* prompts are walked one position per decode step (teacher forcing),
  or, with ``prefill_chunk`` > 0, ingested ``prefill_chunk`` tokens at a
  time through one batched chunked-prefill call per engine step
  (``serve/prefill.py``; token-identical to the walk); each slot decodes
  at its own position.

It runs on ``cuda`` unless the caller passes ``device="cpu"`` (the CPU
takes the kernels' plain versions); with no card and no explicit CPU it
raises.  Deadlines, load shedding, cancellation, faults, telemetry and
the traffic ledger are not ported yet, nor are recurrent (mamba / rwkv)
blocks or data-sharded page pools.
"""
from __future__ import annotations

import math
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, lm_head_weight
from repro_torch.serve.cache import SlotKVCache
from repro_torch.serve.errors import OutOfPages, RequestRejected
from repro_torch.serve.packed import (ROUTED_EXPERT, PackedModel,
                                      activated_scale, choose_block,
                                      pack_model)
from repro_torch.serve.paging import PagedKVCache
from repro_torch.serve.prefill import PrefillPlanner
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.trace import RollingStat
from repro_torch.sparse.format import BitmapWeight, pack_bitmap
from repro_torch.sparse.pruning import (global_l1_prune, per_tensor_prune,
                                        sparsity_of, tree_map)


def _head_block(d_model: int, vocab: int, cap: int = 128):
    """Largest (BK, BN) bitmap tile that divides the head; BN % 8 == 0."""
    return choose_block(d_model, vocab, cap)


def pack_lm_head(params, cfg: ModelConfig, sparsity: float = 0.0,
                 cache_dense: bool = False) -> Optional[BitmapWeight]:
    """Prune (per tensor) and pack the (D, V) LM head once for serving."""
    block = _head_block(cfg.d_model, cfg.vocab_size)
    if block is None:
        return None
    w = lm_head_weight(params, cfg)
    if sparsity > 0:
        w = per_tensor_prune(w, sparsity)
    return pack_bitmap(w.float().contiguous(), block=block,
                       cache_dense=cache_dense)


def _unported(cfg: ModelConfig) -> List[str]:
    out = sorted({f"{b.mixer} mixer" for b in cfg.pattern
                  if b.mixer != "attn"}
                 | {f"{b.ffn} FFN" for b in cfg.pattern
                    if b.ffn not in ("mlp", "moe", "none")})
    if cfg.frontend == "frames":
        out.append("frames frontend")
    return out


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
                 bitmap_head: bool = True,
                 head_sparsity: Optional[float] = None,
                 stream_weights: bool = True, top_k: int = 0,
                 paged: bool = False, page_len: int = 16,
                 page_pool_tokens: Optional[int] = None,
                 prefill_chunk: int = 0, prefix_reuse: bool = False,
                 preempt: bool = False, max_preempts: int = 8,
                 history: int = 512, params: Optional[Dict] = None,
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

        ``history``: retired requests kept for inspection.
        """
        self.device = resolve_device(device)
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} not ported to the "
                f"PyTorch engine yet")
        self.cfg = cfg
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
        self.params = params
        # a dense rendering beside each pack serves the plain version on
        # the CPU; on the card it would hide the kernel, so none is made
        cache_dense = self.device.type == "cpu"
        self.stream_fallback: Optional[str] = None
        if not stream_weights:
            self.stream_fallback = "stream_weights=False"
            self.fallbacks["stream"] = self.stream_fallback
        self.packed: Optional[PackedModel] = (
            pack_model(params, cache_dense=cache_dense)
            if stream_weights else None)
        self.head_sparsity = (sparsity if head_sparsity is None
                              else head_sparsity)
        self.head_fallback: Optional[str] = None
        if bitmap_head:
            self.lm_weight = pack_lm_head(params, cfg, self.head_sparsity,
                                          cache_dense=cache_dense)
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
        self.max_preempts = max_preempts
        self.kv = (PagedKVCache(cfg, num_slots, max_len, self.page_len,
                                pool_tokens=page_pool_tokens,
                                strict=not self.preempt, device=self.device)
                   if self.page_len
                   else SlotKVCache(cfg, num_slots, max_len,
                                    device=self.device))
        self.top_k_default = top_k
        self._step_fn = build_serve_step(cfg, top_k=top_k)
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
        self._prefill_fn = build_prefill_step(cfg)
        self.prefill_steps = 0

        self._tok = np.zeros(num_slots, np.int64)
        self._pos = np.zeros(num_slots, np.int64)
        self._temp = np.zeros(num_slots, np.float32)
        self._topk = np.zeros(num_slots, np.int32)
        self._seeds = np.zeros(num_slots, np.int64)
        self._use_sampling = False
        self._use_topk_vec = False
        self._seed = seed
        self._warm = False
        self._t0: Optional[float] = None
        self._steps = 0
        self.decode_steps = 0
        self._slot_steps = 0
        self._next_rid = 0
        # per-slot ingest = prompt + tokens generated before a
        # preemption: a recomputed request replays its own history
        self._ingest: Dict[int, List[int]] = {}
        self._admit_seq = np.zeros(num_slots, np.int64)  # preempt order
        self._admit_counter = 0
        self._recomputed = 0
        self.history = history
        self.requests: deque = deque(maxlen=max(1, history))
        self._done = 0
        self._gen_tokens = 0
        self._h_lat = RollingStat(seed=1)
        self._h_ftl = RollingStat(seed=2)
        self._h_queue = RollingStat(seed=3)
        self._h_prefill = RollingStat(seed=4)
        self._h_fdec = RollingStat(seed=5)
        self._h_ftl_hit = RollingStat(seed=6)
        self._h_ftl_miss = RollingStat(seed=7)

    @classmethod
    def from_arch(cls, arch: str, smoke: bool = True, **kw) -> "ServeEngine":
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        return cls(cfg, **kw)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warn_fallback(self, key: str, reason: str, message: str) -> None:
        """Record a fallback reason (mirrored into ``report()``) and warn
        it once per (key, reason) per engine."""
        self.fallbacks[key] = reason
        if (key, reason) not in self._warned:
            self._warned.add((key, reason))
            warnings.warn(message, stacklevel=3)

    # ------------------------------------------------------------ clock ----

    def _start_clock(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def _wall(self) -> float:
        return time.perf_counter() - self._t0

    # ------------------------------------------------------------ intake ----

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               arrival: float = 0.0, temperature: float = 0.0,
               seed: Optional[int] = None,
               top_k: Optional[int] = None) -> Request:
        """Queue one request.  ``temperature`` > 0 samples its tokens
        from its own stream, seeded by ``seed`` (default: from the engine
        seed and the rid); ``top_k`` truncates its sampling (None: the
        engine default; 0: none).  Raises ``RequestRejected`` when the
        request can never run: empty prompt, a budget below one token,
        prompt + budget beyond ``max_len``, or, paged, a worst-case page
        need larger than the whole pool."""
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
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, arrival=arrival,
                      temperature=temperature, seed=seed, top_k=top_k)
        if temperature > 0:
            self._use_sampling = True
        if top_k is not None and top_k != self.top_k_default:
            self._use_topk_vec = True
        self._next_rid += 1
        self.scheduler.submit(req)
        return req

    # ------------------------------------------------------------- loop ----

    def _release_slot(self, slot: int, state: RequestState) -> Request:
        """Tear a slot down: planner job, pages, ingest and sampling
        lanes all released."""
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

    def _pinned(self, slot: int) -> bool:
        """A slot whose request used up its preemption budget: it holds
        a worst-case commitment and is never chosen as a victim."""
        req = self.scheduler.active.get(slot)
        return (req is not None
                and len(req.t_preempt) >= self.max_preempts)

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
        victims = [s for s in self.scheduler.active
                   if s != requester and not self._pinned(s)]
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
        if self.planner is not None:
            self.planner.cancel(slot)
        self.scheduler.requeue(slot)
        self.kv.retire(slot)
        self._ingest.pop(slot, None)
        self._pos[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0

    def _retire(self, req: Request) -> None:
        self._done += 1
        self._gen_tokens += len(req.tokens)
        self._h_lat.add(req.latency_s)
        self._h_ftl.add(req.first_token_s)
        self._h_queue.add(req.queue_s)
        self._h_prefill.add(req.prefill_s)
        self._h_fdec.add(req.first_decode_s)
        (self._h_ftl_hit if req.prefix_hit_tokens > 0
         else self._h_ftl_miss).add(req.first_token_s)
        self.requests.append(req)

    def _decode(self):
        tok = torch.from_numpy(self._tok[:, None]).to(self.device)
        pos = torch.from_numpy(self._pos).to(self.device)
        packed = self.packed.blocks if self.packed is not None else None
        kw = dict(lm_weight=self.lm_weight, packed=packed)
        if self.page_len:
            kw["page_tables"] = self.kv.tables()
        if self._use_sampling:
            kw.update(seeds=self._seeds, temperature=self._temp)
            if self._use_topk_vec:
                kw["top_ks"] = self._topk
        return self._step_fn(self.params, self.kv.cache, tok, pos, **kw)

    def _prefill(self, tokens: np.ndarray, pos: np.ndarray,
                 lens: np.ndarray):
        """One chunked-prefill call over the fixed (num_slots, C) batch."""
        packed = self.packed.blocks if self.packed is not None else None
        return self._prefill_fn(
            self.params, self.kv.cache,
            torch.from_numpy(tokens).to(self.device, torch.int64),
            torch.from_numpy(pos).to(self.device, torch.int64),
            torch.from_numpy(lens).to(self.device, torch.int64),
            packed=packed,
            page_tables=self.kv.tables() if self.page_len else None)

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
        for slot in np.nonzero(lens)[0]:
            if self.planner.in_prefill(int(slot)):
                self._pos[slot] = self.planner.next_pos(int(slot))
        self.prefill_steps += 1

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
        """One engine step: admit due requests into free slots, run at
        most one chunked-prefill call, then the full-batch decode step
        and its tokens' routing (skipped when every active slot is
        mid-prefill)."""
        self.warmup()
        self._start_clock()
        now = float(self._steps)
        for r in self.scheduler.waiting:
            if r.arrival <= now and r.t_due is None:
                r.t_due = self._wall()
        # paged: the head-of-line request reserves its pages (check and
        # commit) or queues, strictly FIFO, until retirements free them
        fits = ((lambda r: self.kv.reserve(self._commit_tokens(r)))
                if self.page_len else None)
        for slot, req in self.scheduler.admit(now, fits=fits):
            # a re-admitted request ingests its generated tokens too
            ing = list(req.prompt) + list(req.tokens)
            self._admit_seq[slot] = self._admit_counter
            self._admit_counter += 1
            shared = 0
            if self.page_len:
                blocks = (self.kv.match_prefix(ing)[1]
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
                self._recomputed += max(0, len(ing) - 1 - shared)
            self._pos[slot] = shared
            self._tok[slot] = ing[shared]
            self._temp[slot] = req.temperature
            self._topk[slot] = (req.top_k if req.top_k is not None
                                else self.top_k_default)
            self._seeds[slot] = (req.seed if req.seed is not None
                                 else self._seed + 0x9e37 * (req.rid + 1))
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

        # at most one prefill call per engine step: long prompts
        # interleave chunk calls with decode steps, never starve them
        prefilled = self.planner is not None and self.planner.has_work
        if prefilled:
            self._prefill_call()
        in_prefill = (self.planner.in_prefill if self.planner is not None
                      else lambda s: False)
        decoding = [s for s in self.scheduler.active if not in_prefill(s)]
        if decoding or not prefilled:
            if self.page_len:
                # map each decoding slot's write page, oldest first (a
                # dry pool preempts the youngest, which have not mapped
                # yet); mid-prefill passengers stay unmapped
                for slot in sorted(decoding,
                                   key=lambda s: int(self._admit_seq[s])):
                    if slot in self.scheduler.active:
                        self._with_pages(
                            lambda s=slot: self.kv.ensure(
                                s, int(self._pos[s])), slot)
                decoding = [s for s in self.scheduler.active
                            if not in_prefill(s)]
            self._decode_and_route(len(decoding), in_prefill)
        self._steps += 1

    def _decode_and_route(self, decoding: int, in_prefill) -> None:
        """The full-batch decode step (mid-prefill slots ride along as
        passengers whose output is dropped) and its tokens' routing; a
        filled block is published to the prefix cache, generated blocks
        included."""
        nxt, _, _ = self._decode()
        nxt_host = nxt.cpu().numpy()
        wall = self._wall()
        self._slot_steps += decoding
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
                continue
            t = int(nxt_host[slot])
            req.tokens.append(t)
            ing.append(t)
            if req.t_first is None:
                req.t_first = wall
            self._tok[slot] = t
            if (len(req.tokens) >= req.max_new_tokens
                    or p + 1 >= self.max_len):
                req.t_done = wall
                req.done_step = self._steps
                self._release_slot(slot, RequestState.DONE)
                self._retire(req)
        self.decode_steps += 1

    def run(self) -> dict:
        """Drive until every submitted request has drained; report."""
        self.warmup()
        self._start_clock()
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
        # a step touches at most min(E, num_slots × top_k) experts: the
        # modeled (gather-dispatch) figure; the capacity dispatch executes
        # all E
        activated = (self.num_slots * self.cfg.top_k
                     if self.cfg.num_experts else None)
        if self.packed is not None:
            rep = self.packed.stream_report(activated_experts=activated)
        else:
            dense = 0
            for bd in self.params["blocks"].values():
                for comp, tensors in bd.items():
                    for name, t in tensors.items():
                        routed = (t.shape[1] if (comp, name) in ROUTED_EXPERT
                                  and t.dim() == 4 else 0)
                        dense += int(round(t.numel() * t.element_size()
                                           * activated_scale(routed,
                                                             activated)))
            rep = {"sparse_bytes_per_step": dense,
                   "dense_bytes_per_step": dense, "reduction": 1.0,
                   "packed_tensors": 0, "fallback_tensors": 0,
                   "activated_experts": activated,
                   "fallbacks": {"*": self.stream_fallback
                                 or "stream_weights=False"},
                   "device_sparse_bytes_per_step": dense,
                   "device_dense_bytes_per_step": dense}
        sparse = rep["sparse_bytes_per_step"] + head_sparse
        dense = rep["dense_bytes_per_step"] + head_dense
        return {**rep, "sparse_bytes_per_step": sparse,
                "dense_bytes_per_step": dense,
                "reduction": dense / sparse if sparse else 1.0,
                "device_sparse_bytes_per_step": (
                    rep["device_sparse_bytes_per_step"] + head_sparse),
                "device_dense_bytes_per_step": (
                    rep["device_dense_bytes_per_step"] + head_dense)}

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
                "recomputed_tokens": self._recomputed,
            },
        }
        if self.page_len:
            rep.update(self.kv.prefix_report())
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
        """Serving statistics, under the reference's ``report()`` key
        names for every part this engine has."""
        wall = self._wall() if self._t0 is not None else 0.0
        return {
            "requests": self._done,
            "retained_requests": len(self.requests),
            "generated_tokens": self._gen_tokens,
            "steps": self._steps,
            "wall_s": wall,
            "tok_per_s": (self._gen_tokens / wall if wall > 0
                          else float("nan")),
            "latency_s": self._h_lat.percentiles(),
            "first_token_s": self._h_ftl.percentiles(),
            "ttft": {"queue_s": self._h_queue.percentiles(),
                     "prefill_s": self._h_prefill.percentiles(),
                     "first_decode_s": self._h_fdec.percentiles()},
            "prefill": self.prefill_report(),
            "prefix_reuse": self.prefix_reuse_report(),
            "slot_occupancy": (self._slot_steps
                               / (self._steps * self.num_slots)
                               if self._steps else 0.0),
            "weight_sparsity": self.weight_sparsity,
            "head_compression": self.head_compression,
            "head_fallback": self.head_fallback,
            "weight_stream": self.weight_stream_report(),
            "paging": self.paging_report(),
            "cache_resets": self.kv.resets,
            "fallbacks": dict(self.fallbacks),
        }

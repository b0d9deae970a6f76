"""Paged KV cache: page pools, a refcounted free-list allocator, per-slot
page tables and a shared-prefix page cache for the serving engine.

Port of ``repro/serve/paging.py``.  The host side (free lists,
refcounts, tables, the prefix cache) is the reference's numpy
bookkeeping, so tables, free-list order and page ids are the
reference's exactly; the pools are torch tensors updated in place.

* Each attention block gets a pool of physical pages, shape
  ``(P, pool_pages + 1, page_len, Hkv, hd)``: axis 0 the period stack
  (one page id covers every period of its block), page 0 the reserved
  **trash page** that unmapped table entries point at.  Idle and masked
  batch rows write their lines there, and gathers of unmapped entries
  read lines the attention validity mask always excludes, so pages are
  never zeroed between requests.
* Each slot gets a page table of ``page_slots = ceil(capacity /
  page_len)`` int32 entries per pool (capacity window-bounded for
  sliding-window blocks).  ``tables()`` uploads them to the device as
  int64 once after a mapping changes, and hands the same tensors out on
  every step that changes none.
* Pages are allocated lazily (``ensure`` / ``ensure_range``) off a LIFO
  free list and return to it when their last reference drops.

**Shared prefixes.**  ``page_len``-token prompt blocks hash into a chain
(``sha1(parent_digest ‖ block_tokens)``); each chain node holds one
physical page per pool.  A request whose prompt matches a cached chain
adopts those pages copy-on-write (refcounts bumped, tables mapped,
prefill skipped over them).  A write into a shared page forks it first:
a fresh page is allocated, the page is copied on the device, and the
writer's entry is swapped, so every other holder keeps the original
bytes.  Chains are capped at the smallest pool capacity
(``shareable_tokens``), so no ring wraps inside a shared prefix.

**Commitments.**  With ``strict=True`` a request commits its worst-case
pages at admission and ``ensure`` can never run dry.  With
``strict=False`` (recompute-on-preempt) the engine commits less and a
dry pool raises ``OutOfPages`` once the prefix cache is drained; the
engine then preempts.

**Data shards.**  ``shards`` > 1 partitions the slots into contiguous
groups and each pool's page ids into per-shard ranges, each with its own
trash page, to match a mesh's ``data`` axis: a slot maps only pages of
its own shard; commitments, eviction and confiscated headroom are per
shard; prefix chains are salted per shard.  A rank then needs only its
shard's contiguous page range (``local_shard``: the pools hold just
that range), and the sharded step gathers the pools around each call
(``launch/steps.build_serve_step_spmd``).  Allocation stays on the host,
the same on every rank.  ``shards == 1`` is the one-device layout.

Invariants (``audit()``): each page's refcount equals its table mappings
plus one per prefix-cache hold; every data page is free xor referenced
xor held, per shard; no table entry maps a trash page, another shard's
page, or aliases another entry of the same slot; commitments sum over
the slots' reservations, per shard.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (DTYPES, attn_capacity, init_cache,
                                      paged_addressing, paged_layout)
from repro_torch.serve.errors import AuditViolation, OutOfPages

__all__ = ["OutOfPages", "PagePool", "PagedKVCache", "PrefixBlock"]


@dataclasses.dataclass
class PagePool:
    """Host-side allocator state for one attention block's page pool."""

    bname: str
    capacity: int          # per-slot logical capacity in tokens (no pad)
    page_slots: int        # page-table width = ceil(capacity / page_len)
    pool_pages: int        # allocatable data pages (trash page excluded)
    window: Optional[int]  # sliding-window size (None = full attention)
    ring: bool             # sliding-window ring addressing (mod capacity)
    line_bytes: int        # K+V bytes of one token line across periods
    free: List[int] = dataclasses.field(default_factory=list)
    ref: Dict[int, int] = dataclasses.field(default_factory=dict)
    table: Optional[np.ndarray] = None   # (num_slots, page_slots) int32
    committed: int = 0     # admission-reserved pages
    in_use: int = 0        # pages off the free list (any refcount)
    peak: int = 0
    held: List[int] = dataclasses.field(default_factory=list)
    #                      # pages confiscated from the free list
    #                      # (neither free nor referenced)
    shards: int = 1        # data-axis shard count (1 = one device)
    shard_pages: int = 0   # allocatable data pages per shard
    committed_by: List[int] = dataclasses.field(default_factory=list)
    #                      # per-shard committed pages (sums to committed)


@dataclasses.dataclass
class PrefixBlock:
    """One cached ``page_len``-token prefix block: a node in the hash
    chain holding one physical page per pool.  The cache counts as one
    reference on each page, so its pages outlive their writer."""

    key: bytes                     # sha1(parent_digest || block tokens)
    parent: Optional[bytes]        # previous block in the chain
    index: int                     # block index == table entry == page i
    length: int                    # tokens covered: (index + 1) * page_len
    pages: Dict[str, int]          # bname -> physical page id
    children: int = 0              # cached blocks extending this one
    shard: int = 0                 # owning shard (pages are shard-local)


def _chain_key(parent: Optional[bytes], tokens: Sequence[int]) -> bytes:
    h = hashlib.sha1(parent or b"")
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PagedKVCache:
    """The engine's paged KV cache on ``device`` (``cuda`` unless named,
    ``NoCudaDevice`` without a card).

    Mirrors ``SlotKVCache``'s surface (``cache``, ``resets``) and adds
    the allocator: ``possible``/``fits``/``reserve`` for admission,
    ``admit``/``ensure``/``ensure_range``/``retire`` for the page
    lifecycle, the prefix cache (``match_prefix``/``register_prefix``/
    ``evict_one``/``flush_prefix``), ``tables()`` for the step's page
    tables and ``report()``/``prefix_report()`` for the engine report.

    ``pool_tokens`` bounds each pool to ``ceil(pool_tokens / page_len)``
    data pages (capped at the worst case ``num_slots × page_slots``,
    the default; per shard, each bound divides by ``shards``).
    ``strict`` and ``shards`` as in the module docstring;
    ``local_shard`` (with ``shards`` > 1) keeps only that shard's page
    range in the device pools: page id ``pg`` of shard d lies at
    ``pg - d·(shard_pages + 1)`` there.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 page_len: int, pool_tokens: Optional[int] = None,
                 strict: bool = True, shards: int = 1,
                 local_shard: Optional[int] = None,
                 device: torch.device | str | None = None):
        assert page_len > 0
        assert 1 <= shards <= num_slots and num_slots % shards == 0, \
            (shards, num_slots)
        assert local_shard is None or 0 <= local_shard < shards, \
            (local_shard, shards)
        layout = paged_layout(cfg, max_len, page_len)
        if not layout:
            raise ValueError(f"{cfg.name}: no attention blocks to page")
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_len = page_len
        self.strict = strict
        self.resets = 0
        self.shards = shards
        self.local_shard = local_shard if shards > 1 else None
        # slots partition into `shards` contiguous groups
        self._slot_shard = (np.arange(num_slots) * shards
                            // num_slots).astype(np.int64)

        kv_line = (2 * cfg.num_periods * cfg.num_kv_heads
                   * cfg.resolved_head_dim
                   * DTYPES[cfg.compute_dtype].itemsize)
        budget = (-(-pool_tokens // page_len)
                  if pool_tokens is not None else None)
        self.pools: Dict[str, PagePool] = {}
        for i, blk in enumerate(cfg.pattern):
            bname = f"b{i}"
            if bname not in layout:
                continue
            slots = layout[bname]
            _, ring = paged_addressing(slots, page_len, blk.window)
            # each shard serves num_slots / shards slots out of its own
            # range, so the worst case and a budget divide by the count
            worst = (num_slots // shards) * slots
            per = (worst if budget is None
                   else max(1, min(-(-budget // shards), worst)))
            self.pools[bname] = PagePool(
                bname=bname, capacity=attn_capacity(blk, max_len),
                page_slots=slots, pool_pages=per * shards,
                window=blk.window, ring=ring, line_bytes=kv_line,
                # shard d owns ids d·(per+1)+1 .. d·(per+1)+per, and id
                # d·(per+1) is its trash page (one shard: trash 0, data
                # 1..pool_pages), popped from the end (LIFO)
                free=[d * (per + 1) + pg for d in range(shards - 1, -1, -1)
                      for pg in range(per, 0, -1)],
                table=np.zeros((num_slots, slots), np.int32),
                shards=shards, shard_pages=per, committed_by=[0] * shards)

        # chains cap at the smallest pool capacity (padded), so no ring
        # wraps inside a shared region: block i is table entry i in
        # every pool
        self.shareable_tokens = min(
            paged_addressing(p.page_slots, page_len, p.window)[0]
            for p in self.pools.values())
        self.prefix: "OrderedDict[bytes, PrefixBlock]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.forks = 0

        self.cache = init_cache(
            cfg, num_slots, max_len, device=device, page_len=page_len,
            pool_pages={b: (p.shard_pages + 1 if self.local_shard is not None
                            else p.pool_pages + p.shards)
                        for b, p in self.pools.items()})
        self.device = self.cache[next(iter(self.pools))]["k"].device
        self._commit: List[Dict[str, int]] = [{} for _ in range(num_slots)]
        # device tables: mappings change on a few steps per request
        # (admit, page boundary, retire), so steps reuse one upload
        self._dev_tables: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------- admission ----

    def pages_for(self, need_tokens: int) -> Dict[str, int]:
        """Worst-case pages per pool for positions ``0 .. need_tokens-1``.
        Ring pools cap at their table width: positions past the window
        wrap onto entries already counted.  ``possible``, ``fits``,
        ``reserve`` and the bound commitment all go through this cap."""
        n = -(-max(need_tokens, 1) // self.page_len)
        return {b: min(n, p.page_slots) for b, p in self.pools.items()}

    def slot_shard(self, slot: int) -> int:
        """The shard whose page range ``slot`` allocates from."""
        return int(self._slot_shard[slot])

    def _page_shard(self, pool: PagePool, pg: int) -> int:
        """Owning shard of a page id (trash pages included)."""
        return pg // (pool.shard_pages + 1)

    def _shard_held(self, pool: PagePool, d: int) -> int:
        if pool.shards == 1:
            return len(pool.held)
        return sum(1 for pg in pool.held if self._page_shard(pool, pg) == d)

    def possible(self, need_tokens: int) -> bool:
        """Can this request ever be admitted (empty engine)?  A request
        is admitted into one shard's range, so the bound is per shard."""
        return all(n <= self.pools[b].shard_pages
                   for b, n in self.pages_for(need_tokens).items())

    def fits(self, need_tokens: int, slot: int = 0) -> bool:
        """Can this request be admitted now, into ``slot``'s shard,
        without risking mid-flight exhaustion for anyone already
        committed there?  Confiscated pages shrink the usable shard
        until restored."""
        d = self.slot_shard(slot)
        return all(self.pools[b].committed_by[d] + n
                   <= self.pools[b].shard_pages
                   - self._shard_held(self.pools[b], d)
                   for b, n in self.pages_for(need_tokens).items())

    def reserve(self, need_tokens: int, slot: int = 0) -> bool:
        """Check and commit in one step (the scheduler's admission gate),
        so several admissions in one pass cannot all pass a stale check.
        ``admit`` then binds the reservation to its slot; ``slot`` must
        be that slot or one of its shard, so that the commitment lands
        in the right shard.  Strict mode passes the worst-case need,
        preemptible mode the live ingest."""
        if not self.fits(need_tokens, slot=slot):
            return False
        d = self.slot_shard(slot)
        for b, n in self.pages_for(need_tokens).items():
            self.pools[b].committed += n
            self.pools[b].committed_by[d] += n
        return True

    def admit(self, slot: int, need_tokens: int,
              prefix: Optional[List[PrefixBlock]] = None) -> int:
        """Bind a prior ``reserve`` to ``slot``, zero the slot's
        recurrent state (every leaf but the page pools: mamba ``h`` /
        ``conv``, rwkv ``s`` / ``x_prev``, ``cm_x_prev``), and adopt any
        matched prefix blocks copy-on-write; returns the adopted
        (prefill-skippable) tokens.  Nothing is allocated, and pages are
        never zeroed."""
        assert 0 <= slot < self.num_slots
        assert not self._commit[slot], f"slot {slot} not retired"
        self._commit[slot] = self.pages_for(need_tokens)
        for bname, leaf in self.cache.items():
            for k, t in leaf.items():
                if not (bname in self.pools and k in ("k", "v")):
                    t[:, slot].zero_()
        self.resets += 1
        # prefix=None: reuse off (no accounting); []: a counted miss
        return (self.adopt_prefix(slot, prefix)
                if prefix is not None else 0)

    # ------------------------------------------------------- allocator ----

    def _has_free(self, pool: PagePool, d: int) -> bool:
        if pool.shards == 1:
            return bool(pool.free)
        return any(self._page_shard(pool, pg) == d for pg in pool.free)

    def _pop_free(self, pool: PagePool, d: int) -> int:
        """Pop shard ``d``'s most recently freed page (a plain LIFO pop
        on one shard)."""
        if pool.shards == 1:
            return pool.free.pop()
        for i in range(len(pool.free) - 1, -1, -1):
            if self._page_shard(pool, pool.free[i]) == d:
                return pool.free.pop(i)
        raise IndexError(f"shard {d}: no free page")

    def _alloc(self, bname: str, pool: PagePool, shard: int = 0) -> int:
        """Pop a fresh page off ``shard``'s range (refcount 1), draining
        that shard's cache-only prefix pages first when it is dry."""
        while not self._has_free(pool, shard) and \
                self.evict_one(prefer=bname, shard=shard):
            pass
        if not self._has_free(pool, shard):
            if self.strict:
                raise AssertionError(
                    f"{bname}: shard {shard} free list empty with "
                    f"{pool.committed_by[shard]} committed of "
                    f"{pool.shard_pages} and no evictable prefix — "
                    f"commitment invariant broken")
            raise OutOfPages(bname)
        pg = self._pop_free(pool, shard)
        pool.ref[pg] = 1
        pool.in_use += 1
        pool.peak = max(pool.peak, pool.in_use)
        return pg

    def _deref(self, bname: str, pool: PagePool, pg: int) -> None:
        assert pg in pool.ref and pool.ref[pg] >= 1, \
            f"{bname}: double free of page {pg}"
        pool.ref[pg] -= 1
        if pool.ref[pg] == 0:
            del pool.ref[pg]
            pool.free.append(pg)
            pool.in_use -= 1

    def _fork(self, bname: str, pool: PagePool, slot: int,
              pi: int) -> None:
        """Copy-on-write: give ``slot`` a private copy of its shared
        entry ``pi`` before it writes there.  The copy is issued now, on
        the stream the step's write will follow it on (by the rank that
        holds the slot's shard)."""
        d = self.slot_shard(slot)
        src = int(pool.table[slot, pi])
        dst = self._alloc(bname, pool, d)
        if self.local_shard in (None, d):
            base = (0 if self.local_shard is None
                    else d * (pool.shard_pages + 1))
            for kk in ("k", "v"):
                t = self.cache[bname][kk]
                t[:, dst - base].copy_(t[:, src - base])
        pool.table[slot, pi] = dst
        self._deref(bname, pool, src)
        self.forks += 1
        self._dev_tables = None

    def _map_page(self, bname: str, pool: PagePool, slot: int,
                  pi: int) -> None:
        """Make entry ``pi`` privately writable by ``slot``: allocate
        when unmapped, fork when shared, nothing when owned.  With the
        list dry an eviction is tried first: dropping the cache's hold
        on this very page may resolve the share with no copy."""
        d = self.slot_shard(slot)
        pg = int(pool.table[slot, pi])
        if pg == 0:
            pool.table[slot, pi] = self._alloc(bname, pool, d)
            self._dev_tables = None
            return
        while pool.ref[pg] > 1:
            if not self._has_free(pool, d):
                if self.evict_one(prefer=bname, shard=d):
                    continue
                if self.strict:
                    raise AssertionError(
                        f"{bname}: shared page {pg} needs a fork but the "
                        f"pool is dry — commitment invariant broken")
                raise OutOfPages(bname)
            self._fork(bname, pool, slot, pi)
            return

    def _entry(self, pool: PagePool, pos: int) -> int:
        """Table entry of position ``pos``'s write line, with the device
        write's addressing (``model.paged_addressing``)."""
        cap, ring = paged_addressing(pool.page_slots, self.page_len,
                                     pool.window)
        return (pos % cap if ring else min(max(pos, 0), cap - 1)) \
            // self.page_len

    def ensure(self, slot: int, pos: int) -> None:
        """Make the page holding ``pos``'s write line privately
        writable, allocating (or forking a shared page) lazily."""
        for b, pool in self.pools.items():
            self._map_page(b, pool, slot, self._entry(pool, pos))

    def ensure_range(self, slot: int, start: int, end: int) -> None:
        """Map every page a chunk writing positions ``start .. end-1``
        touches, in first-touch order, before the prefill call (a ring
        that wraps inside the range maps its whole table)."""
        if end <= start:
            return
        for b, pool in self.pools.items():
            cap, ring = paged_addressing(pool.page_slots, self.page_len,
                                         pool.window)
            span = range(start, min(end, start + cap) if ring else end)
            for pi in dict.fromkeys(self._entry(pool, p) for p in span):
                self._map_page(b, pool, slot, pi)

    def retire(self, slot: int) -> None:
        """Drop the slot's references and uncommit.  Pages the prefix
        cache (or another slot) still holds stay resident for the next
        request with the same prompt."""
        self._dev_tables = None
        d = self.slot_shard(slot)
        for b, pool in self.pools.items():
            row = pool.table[slot]
            for pg in [int(p) for p in row[row != 0]]:
                self._deref(b, pool, pg)
            row[:] = 0
            pool.committed -= self._commit[slot].get(b, 0)
            pool.committed_by[d] -= self._commit[slot].get(b, 0)
        self._commit[slot] = {}

    # ---------------------------------------------------- prefix cache ----

    def _chain(self, tokens: Sequence[int], upto: int,
               shard: int = 0) -> List[bytes]:
        """Chain keys of the fully covered shareable blocks of
        ``tokens[:upto]``, salted per shard (shard 0 keeps the unsalted
        keys), so that a prompt cached in one shard's range never
        matches from another."""
        limit = min(upto, self.shareable_tokens)
        keys, parent = [], bytes([shard]) if shard else None
        for i in range(limit // self.page_len):
            parent = _chain_key(
                parent, tokens[i * self.page_len:(i + 1) * self.page_len])
            keys.append(parent)
        return keys

    def match_prefix(self, tokens: Sequence[int], slot: int = 0
                     ) -> Tuple[int, List[PrefixBlock]]:
        """Longest cached chain (in ``slot``'s shard) matching the
        prompt's leading blocks, capped at ``len(tokens) - 1`` (the last
        prompt token always goes through the first decode step) and at
        ``shareable_tokens``.  Matched entries are LRU-touched.  Returns
        (tokens, blocks)."""
        blocks: List[PrefixBlock] = []
        for key in self._chain(tokens, len(tokens) - 1,
                               self.slot_shard(slot)):
            entry = self.prefix.get(key)
            if entry is None:
                break
            self.prefix.move_to_end(key)
            blocks.append(entry)
        return len(blocks) * self.page_len, blocks

    def adopt_prefix(self, slot: int,
                     blocks: Sequence[PrefixBlock]) -> int:
        """Map matched blocks into the slot's (freshly retired) tables
        copy-on-write: refcounts bumped, nothing allocated."""
        for e in blocks:
            for b, pg in e.pages.items():
                pool = self.pools[b]
                assert pool.table[slot, e.index] == 0, \
                    f"{b}: adopting into a mapped entry"
                pool.table[slot, e.index] = pg
                pool.ref[pg] += 1
        if blocks:
            self._dev_tables = None
            self.prefix_hits += 1
            self.hit_tokens += len(blocks) * self.page_len
        else:
            self.prefix_misses += 1
        return len(blocks) * self.page_len

    def register_prefix(self, slot: int, tokens: Sequence[int],
                        upto: int) -> None:
        """Publish the slot's fully written leading blocks (``upto``
        positions written) into the prefix cache, one cache reference
        per page.  Cached blocks are only LRU-touched; the chain stops at
        the first entry this slot has not written, so children always
        have cached parents.  Refused past ``shareable_tokens``: a ring
        has wrapped there and low entries no longer hold their blocks."""
        if upto > self.shareable_tokens:
            return
        shard = self.slot_shard(slot)
        parent: Optional[bytes] = None
        for i, key in enumerate(self._chain(tokens, upto, shard)):
            entry = self.prefix.get(key)
            if entry is not None:
                self.prefix.move_to_end(key)
                parent = key
                continue
            pages = {}
            for b, pool in self.pools.items():
                pg = int(pool.table[slot, i])
                if pg == 0:          # entry not written by this slot
                    return
                pages[b] = pg
            for b, pg in pages.items():
                self.pools[b].ref[pg] += 1
            self.prefix[key] = PrefixBlock(
                key=key, parent=parent, index=i,
                length=(i + 1) * self.page_len, pages=pages, shard=shard)
            if parent is not None:
                self.prefix[parent].children += 1
            parent = key

    def evict_one(self, prefer: Optional[str] = None,
                  shard: Optional[int] = None) -> bool:
        """Evict one leaf prefix block in LRU order.  ``prefer`` picks,
        among leaves, the oldest whose page in that pool is cache-only
        (so the eviction frees a page there), else the oldest leaf;
        ``shard`` keeps to that shard's blocks (another shard's pages
        cannot serve its slots).  False when nothing is evictable."""
        chosen = None
        for key, e in self.prefix.items():
            if e.children:
                continue
            if shard is not None and e.shard != shard:
                continue
            if prefer is not None and self.pools[prefer].ref.get(
                    e.pages[prefer], 0) == 1:
                chosen = key
                break
            if chosen is None:
                chosen = key
                if prefer is None:
                    break
        if chosen is None:
            return False
        e = self.prefix.pop(chosen)
        if e.parent is not None and e.parent in self.prefix:
            self.prefix[e.parent].children -= 1
        for b, pg in e.pages.items():
            self._deref(b, self.pools[b], pg)
        self.evictions += 1
        return True

    def flush_prefix(self) -> int:
        """Evict the whole prefix cache; returns the blocks evicted."""
        n = 0
        while self.evict_one():
            n += 1
        return n

    # ---------------------------------------------------- page squeeze ----

    def confiscate(self, n: int) -> int:
        """Pull up to ``n`` free pages per pool out of circulation
        (neither free nor referenced), newest first.  Strict mode takes
        only each shard's uncommitted headroom, so ``ensure`` still
        cannot fail.  Returns the pages held in total."""
        taken = 0
        for pool in self.pools.values():
            if self.strict:
                room = [max(0, pool.shard_pages - pool.committed_by[d]
                            - self._shard_held(pool, d))
                        for d in range(pool.shards)]
            else:
                room = [len(pool.free)] * pool.shards
            took = 0
            i = len(pool.free) - 1
            while took < n and i >= 0:
                d = self._page_shard(pool, pool.free[i])
                if room[d] > 0:
                    room[d] -= 1
                    pool.held.append(pool.free.pop(i))
                    took += 1
                i -= 1
            taken += took
        return taken

    def restore_held(self) -> int:
        """Return every confiscated page to its free list (idempotent);
        returns the pages restored."""
        out = 0
        for pool in self.pools.values():
            out += len(pool.held)
            while pool.held:
                pool.free.append(pool.held.pop())
        return out

    # ------------------------------------------------------------ audit ----

    def audit(self, commit_check: bool = True) -> None:
        """Allocator invariants (raises ``AuditViolation``): exact
        refcounts; free xor referenced xor held, no double free, and per
        shard ``free + referenced + held == shard_pages``; no entry maps a
        trash page or another shard's page (a prefix block holds pages of
        its own shard) or aliases another entry of its slot; ``in_use``
        counts the referenced pages; commitments sum the slots', per
        shard and overall."""
        for b, pool in self.pools.items():
            span = pool.shard_pages + 1       # a shard's range, trash too
            refs: Dict[int, int] = {}
            for slot in range(self.num_slots):
                row = pool.table[slot]
                live = [int(p) for p in row[row != 0]]
                if len(live) != len(set(live)):
                    raise AuditViolation(
                        f"{b}: slot {slot} table aliases a page: {live}")
                d = self.slot_shard(slot)
                stray = [pg for pg in live
                         if self._page_shard(pool, pg) != d]
                if stray:
                    raise AuditViolation(
                        f"{b}: slot {slot} (shard {d}) maps pages from "
                        f"another shard: {stray}")
                for pg in live:
                    refs[pg] = refs.get(pg, 0) + 1
            for e in self.prefix.values():
                pg = e.pages[b]
                if self._page_shard(pool, pg) != e.shard:
                    raise AuditViolation(
                        f"{b}: prefix block of shard {e.shard} holds "
                        f"page {pg} of shard {self._page_shard(pool, pg)}")
                refs[pg] = refs.get(pg, 0) + 1
            if refs != pool.ref:
                drift = {pg: (refs.get(pg), pool.ref.get(pg))
                         for pg in set(refs) | set(pool.ref)
                         if refs.get(pg) != pool.ref.get(pg)}
                raise AuditViolation(f"{b}: refcount drift "
                                     f"(actual, recorded) = {drift}")
            free = pool.free
            if len(free) != len(set(free)):
                raise AuditViolation(f"{b}: duplicate free page")
            if set(free) & set(refs):
                raise AuditViolation(
                    f"{b}: page both free and referenced: "
                    f"{sorted(set(free) & set(refs))}")
            ids = set(free) | set(refs) | set(pool.held)
            if not all(0 < pg < pool.shards * span and pg % span != 0
                       for pg in ids):
                raise AuditViolation(
                    f"{b}: page id out of range (trash page leaked?)")
            for d in range(pool.shards):
                nf = sum(1 for pg in free if self._page_shard(pool, pg) == d)
                nr = sum(1 for pg in refs if self._page_shard(pool, pg) == d)
                nh = self._shard_held(pool, d)
                if nf + nr + nh != pool.shard_pages:
                    raise AuditViolation(
                        f"{b}: shard {d} conservation broken — {nf} free "
                        f"+ {nr} referenced + {nh} held "
                        f"!= {pool.shard_pages}")
            if pool.in_use != len(refs):
                raise AuditViolation(
                    f"{b}: in_use={pool.in_use} != {len(refs)} referenced")
            if commit_check:
                for d in range(pool.shards):
                    want = sum(c.get(b, 0)
                               for slot, c in enumerate(self._commit)
                               if self.slot_shard(slot) == d)
                    if pool.committed_by[d] != want:
                        raise AuditViolation(
                            f"{b}: shard {d} committed="
                            f"{pool.committed_by[d]} != {want} summed "
                            f"over slot reservations")
                    if pool.committed_by[d] > pool.shard_pages:
                        raise AuditViolation(
                            f"{b}: shard {d} over-committed "
                            f"{pool.committed_by[d]} of "
                            f"{pool.shard_pages}")
                if pool.committed != sum(pool.committed_by):
                    raise AuditViolation(
                        f"{b}: committed={pool.committed} != per-shard "
                        f"sum {sum(pool.committed_by)}")

    # ------------------------------------------------------------ step ----

    def tables(self) -> Dict[str, torch.Tensor]:
        """The step's page tables on the device, int64: uploaded once
        after a mapping changed, the same tensors otherwise (no upload
        and no host sync on steps that change no mapping).  Page ids are
        global: sharded pools' unmapped entries (host 0) point at the
        slot's own shard's trash page (shard 0's is page 0), so that
        idle lanes write inside their shard's range."""
        if self._dev_tables is None:
            self._dev_tables = {}
            for b, p in self.pools.items():
                table = p.table
                if self.shards > 1:
                    trash = self._slot_shard * (p.shard_pages + 1)
                    table = np.where(table == 0, trash[:, None], table)
                self._dev_tables[b] = torch.from_numpy(
                    np.ascontiguousarray(table)).to(self.device, torch.int64)
        return self._dev_tables

    # --------------------------------------------------------- reports ----

    def register_metrics(self, reg) -> None:
        """Expose allocator and prefix-cache counters as gauges."""
        reg.gauge("kv.resets", lambda: self.resets)
        reg.gauge("kv.reserved_bytes", self.reserved_kv_bytes)
        reg.gauge("paging.pages_in_use",
                  lambda: sum(p.in_use for p in self.pools.values()))
        reg.gauge("paging.pages_peak",
                  lambda: sum(p.peak for p in self.pools.values()))
        reg.gauge("paging.pages_total",
                  lambda: sum(p.pool_pages for p in self.pools.values()))
        reg.gauge("prefix.hits", lambda: self.prefix_hits)
        reg.gauge("prefix.misses", lambda: self.prefix_misses)
        reg.gauge("prefix.hit_tokens", lambda: self.hit_tokens)
        reg.gauge("prefix.evictions", lambda: self.evictions)
        reg.gauge("prefix.forks", lambda: self.forks)
        reg.gauge("prefix.cached_blocks", lambda: len(self.prefix))

    def reserved_kv_bytes(self) -> int:
        """Bytes reserved for KV pages over every shard, trash pages
        included (one per shard)."""
        return sum((p.pool_pages + p.shards) * self.page_len * p.line_bytes
                   for p in self.pools.values())

    def contiguous_kv_bytes(self) -> int:
        """What the contiguous layout would reserve for the same engine."""
        return sum(self.num_slots * p.capacity * p.line_bytes
                   for p in self.pools.values())

    def prefix_report(self) -> Dict:
        """Shared-prefix cache counters for the engine report."""
        lookups = self.prefix_hits + self.prefix_misses
        return {
            "cached_blocks": len(self.prefix),
            "cached_tokens": len(self.prefix) * self.page_len,
            "shareable_tokens": self.shareable_tokens,
            "hits": self.prefix_hits,
            "misses": self.prefix_misses,
            "hit_rate": (self.prefix_hits / lookups if lookups else None),
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
            "forks": self.forks,
        }

    def report(self, positions: Optional[Sequence[int]] = None) -> Dict:
        """Pages in use / peak / total, reserved against contiguous KV
        bytes, and — given the active slots' positions — the
        allocated-but-dead share of in-use page tokens."""
        reserved = self.reserved_kv_bytes()
        contiguous = self.contiguous_kv_bytes()
        frag = None
        if positions is not None:
            alloc_tokens = live_tokens = 0
            for p in self.pools.values():
                alloc_tokens += p.in_use * self.page_len
                live_tokens += sum(min(pos + 1, p.capacity)
                                   for pos in positions)
            frag = (1.0 - live_tokens / alloc_tokens if alloc_tokens
                    else 0.0)
        return {
            "page_len": self.page_len,
            "shards": self.shards,
            "pages_in_use": sum(p.in_use for p in self.pools.values()),
            "pages_peak": sum(p.peak for p in self.pools.values()),
            "pages_total": sum(p.pool_pages for p in self.pools.values()),
            "pools": {b: {"pages": p.pool_pages, "in_use": p.in_use,
                          "peak": p.peak, "page_slots": p.page_slots,
                          "ring": p.ring, "held": len(p.held),
                          "shard_pages": p.shard_pages}
                      for b, p in self.pools.items()},
            "reserved_kv_bytes": reserved,
            "contiguous_kv_bytes": contiguous,
            "reserved_reduction": (contiguous / reserved if reserved
                                   else 1.0),
            "fragmentation": frag,
        }

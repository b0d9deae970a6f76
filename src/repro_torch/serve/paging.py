"""Paged KV cache: page pools, a refcounted free-list allocator, per-slot
page tables and a shared-prefix page cache for the serving engine.

Port of ``repro/serve/paging.py`` on one device.  The host side (free
lists, refcounts, tables, the prefix cache) is the reference's numpy
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

Invariants (``audit()``): each page's refcount equals its table mappings
plus one per prefix-cache hold; every data page is free xor referenced
xor held; no table entry maps the trash page or aliases another entry
of the same slot; commitments sum over the slots' reservations.
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
    the default).  ``strict`` as in the module docstring.  One device
    only: ``shards > 1`` (data-sharded pools) raises.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 page_len: int, pool_tokens: Optional[int] = None,
                 strict: bool = True, shards: int = 1,
                 device: torch.device | str | None = None):
        assert page_len > 0
        if shards != 1:
            raise NotImplementedError(
                "data-sharded page pools (shards > 1) are not ported: "
                "ROADMAP.md queue 1 item 6 (multiple GPUs)")
        layout = paged_layout(cfg, max_len, page_len)
        if not layout:
            raise ValueError(f"{cfg.name}: no attention blocks to page")
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_len = page_len
        self.strict = strict
        self.shards = 1
        self.resets = 0

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
            worst = num_slots * slots
            pages = worst if budget is None else max(1, min(budget, worst))
            self.pools[bname] = PagePool(
                bname=bname, capacity=attn_capacity(blk, max_len),
                page_slots=slots, pool_pages=pages, window=blk.window,
                ring=ring, line_bytes=kv_line,
                # data ids 1..pool_pages, popped from the end (LIFO)
                free=list(range(pages, 0, -1)),
                table=np.zeros((num_slots, slots), np.int32))

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
            pool_pages={b: p.pool_pages + 1 for b, p in self.pools.items()})
        self.device = next(iter(self.cache.values()))["k"].device
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

    def possible(self, need_tokens: int) -> bool:
        """Can this request ever be admitted (empty engine)?"""
        return all(n <= self.pools[b].pool_pages
                   for b, n in self.pages_for(need_tokens).items())

    def fits(self, need_tokens: int) -> bool:
        """Can this request be admitted now without risking mid-flight
        exhaustion for anyone already committed?  Confiscated pages
        shrink the usable pool until restored."""
        return all(self.pools[b].committed + n
                   <= self.pools[b].pool_pages - len(self.pools[b].held)
                   for b, n in self.pages_for(need_tokens).items())

    def reserve(self, need_tokens: int) -> bool:
        """Check and commit in one step (the scheduler's admission gate),
        so several admissions in one pass cannot all pass a stale check.
        ``admit`` then binds the reservation to its slot.  Strict mode
        passes the worst-case need, preemptible mode the live ingest."""
        if not self.fits(need_tokens):
            return False
        for b, n in self.pages_for(need_tokens).items():
            self.pools[b].committed += n
        return True

    def admit(self, slot: int, need_tokens: int,
              prefix: Optional[List[PrefixBlock]] = None) -> int:
        """Bind a prior ``reserve`` to ``slot`` and adopt any matched
        prefix blocks copy-on-write; returns the adopted (prefill-
        skippable) tokens.  Nothing is allocated and nothing is zeroed:
        pages never are, and the ported blocks are all attention, with
        no per-slot recurrent state (the reference zeroes that here)."""
        assert 0 <= slot < self.num_slots
        assert not self._commit[slot], f"slot {slot} not retired"
        self._commit[slot] = self.pages_for(need_tokens)
        self.resets += 1
        # prefix=None: reuse off (no accounting); []: a counted miss
        return (self.adopt_prefix(slot, prefix)
                if prefix is not None else 0)

    # ------------------------------------------------------- allocator ----

    def _alloc(self, bname: str, pool: PagePool) -> int:
        """Pop a fresh page (refcount 1), draining cache-only prefix
        pages first when the free list is dry."""
        while not pool.free and self.evict_one(prefer=bname):
            pass
        if not pool.free:
            if self.strict:
                raise AssertionError(
                    f"{bname}: free list empty with {pool.committed} "
                    f"committed of {pool.pool_pages} and no evictable "
                    f"prefix — commitment invariant broken")
            raise OutOfPages(bname)
        pg = pool.free.pop()
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
        the stream the step's write will follow it on."""
        src = int(pool.table[slot, pi])
        dst = self._alloc(bname, pool)
        for t in self.cache[bname].values():
            t[:, dst].copy_(t[:, src])
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
        pg = int(pool.table[slot, pi])
        if pg == 0:
            pool.table[slot, pi] = self._alloc(bname, pool)
            self._dev_tables = None
            return
        while pool.ref[pg] > 1:
            if not pool.free:
                if self.evict_one(prefer=bname):
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
        for b, pool in self.pools.items():
            row = pool.table[slot]
            for pg in [int(p) for p in row[row != 0]]:
                self._deref(b, pool, pg)
            row[:] = 0
            pool.committed -= self._commit[slot].get(b, 0)
        self._commit[slot] = {}

    # ---------------------------------------------------- prefix cache ----

    def _chain(self, tokens: Sequence[int], upto: int) -> List[bytes]:
        """Chain keys of the fully covered shareable blocks of
        ``tokens[:upto]``."""
        limit = min(upto, self.shareable_tokens)
        keys, parent = [], None
        for i in range(limit // self.page_len):
            parent = _chain_key(
                parent, tokens[i * self.page_len:(i + 1) * self.page_len])
            keys.append(parent)
        return keys

    def match_prefix(self, tokens: Sequence[int]
                     ) -> Tuple[int, List[PrefixBlock]]:
        """Longest cached chain matching the prompt's leading blocks,
        capped at ``len(tokens) - 1`` (the last prompt token always goes
        through the first decode step) and at ``shareable_tokens``.
        Matched entries are LRU-touched.  Returns (tokens, blocks)."""
        blocks: List[PrefixBlock] = []
        for key in self._chain(tokens, len(tokens) - 1):
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
        parent: Optional[bytes] = None
        for i, key in enumerate(self._chain(tokens, upto)):
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
                length=(i + 1) * self.page_len, pages=pages)
            if parent is not None:
                self.prefix[parent].children += 1
            parent = key

    def evict_one(self, prefer: Optional[str] = None) -> bool:
        """Evict one leaf prefix block in LRU order.  ``prefer`` picks,
        among leaves, the oldest whose page in that pool is cache-only
        (so the eviction frees a page there), else the oldest leaf.
        False when nothing is evictable."""
        chosen = None
        for key, e in self.prefix.items():
            if e.children:
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
        only uncommitted headroom, so ``ensure`` still cannot fail.
        Returns the pages held in total."""
        taken = 0
        for pool in self.pools.values():
            room = (max(0, pool.pool_pages - pool.committed
                        - len(pool.held))
                    if self.strict else len(pool.free))
            take = min(n, room, len(pool.free))
            for _ in range(take):
                pool.held.append(pool.free.pop())
            taken += take
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
        refcounts; free xor referenced xor held, no double free, and
        ``free + referenced + held == pool_pages``; no entry maps the
        trash page or aliases another entry of its slot; ``in_use``
        counts the referenced pages; commitments sum the slots'."""
        for b, pool in self.pools.items():
            refs: Dict[int, int] = {}
            for slot in range(self.num_slots):
                row = pool.table[slot]
                live = [int(p) for p in row[row != 0]]
                if len(live) != len(set(live)):
                    raise AuditViolation(
                        f"{b}: slot {slot} table aliases a page: {live}")
                for pg in live:
                    refs[pg] = refs.get(pg, 0) + 1
            for e in self.prefix.values():
                refs[e.pages[b]] = refs.get(e.pages[b], 0) + 1
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
            if not all(0 < pg <= pool.pool_pages for pg in ids):
                raise AuditViolation(
                    f"{b}: page id out of range (trash page leaked?)")
            if len(free) + len(refs) + len(pool.held) != pool.pool_pages:
                raise AuditViolation(
                    f"{b}: conservation broken — {len(free)} free + "
                    f"{len(refs)} referenced + {len(pool.held)} held "
                    f"!= {pool.pool_pages}")
            if pool.in_use != len(refs):
                raise AuditViolation(
                    f"{b}: in_use={pool.in_use} != {len(refs)} referenced")
            if commit_check:
                want = sum(c.get(b, 0) for c in self._commit)
                if pool.committed != want:
                    raise AuditViolation(
                        f"{b}: committed={pool.committed} != {want} "
                        f"summed over slot reservations")
                if pool.committed > pool.pool_pages:
                    raise AuditViolation(
                        f"{b}: over-committed {pool.committed} of "
                        f"{pool.pool_pages}")

    # ------------------------------------------------------------ step ----

    def tables(self) -> Dict[str, torch.Tensor]:
        """The step's page tables on the device, int64: uploaded once
        after a mapping changed, the same tensors otherwise (no upload
        and no host sync on steps that change no mapping)."""
        if self._dev_tables is None:
            self._dev_tables = {
                b: torch.from_numpy(p.table).to(self.device, torch.int64)
                for b, p in self.pools.items()}
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
        """Bytes reserved for KV pages, trash page included."""
        return sum((p.pool_pages + 1) * self.page_len * p.line_bytes
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
                          "shard_pages": p.pool_pages}
                      for b, p in self.pools.items()},
            "reserved_kv_bytes": reserved,
            "contiguous_kv_bytes": contiguous,
            "reserved_reduction": (contiguous / reserved if reserved
                                   else 1.0),
            "fragmentation": frag,
        }

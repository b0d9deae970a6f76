"""Port's data-sharded ``PagedKVCache(shards=S)`` against the JAX
package's, op for op: per-shard page ranges, free lists, commitments,
shard-salted prefix chains, confiscated headroom, the per-shard audit
and the tables' trash-page rewrite.  Beside them, one port cache per
shard keeps only that shard's page range (``local_shard``), as a rank
of a sharded world does; its pools must equal the reference's chunk
after every copy-on-write fork."""
import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.serve.paging import PagedKVCache as RefPaged
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.serve import PagedKVCache


def _state(kv):
    """Everything the allocator decides, in comparable form."""
    pools = {b: (p.table.tolist(), list(p.free), dict(p.ref), p.committed,
                 list(p.committed_by), p.in_use, p.peak, list(p.held),
                 p.pool_pages, p.shard_pages, p.shards)
             for b, p in kv.pools.items()}
    prefix = [(e.key, e.parent, e.index, e.length, dict(e.pages),
               e.children, e.shard) for e in kv.prefix.values()]
    counters = (kv.prefix_hits, kv.prefix_misses, kv.hit_tokens,
                kv.evictions, kv.forks, kv.resets, kv.shareable_tokens)
    return pools, prefix, counters, [dict(c) for c in kv._commit]


def _call(fn):
    """(result, exception class name): OutOfPages and the strict
    commitment assertion are outcomes to compare, not failures."""
    try:
        return fn(), None
    except (AssertionError, RuntimeError) as e:
        return None, type(e).__name__


def _each(caches, fn):
    """``fn`` on every cache; all must give the same outcome."""
    outs = [_call(lambda c=c: fn(c)) for c in caches]
    assert all(o == outs[0] for o in outs), outs
    return outs[0]


def _caches(arch, slots, max_len, page_len, shards, seed, **kw):
    """The reference, the port, and one port cache per shard holding
    only that shard's pages, their pools filled with the same distinct
    bytes (so that a fork's copy is checked)."""
    ref = RefPaged(ref_smoke(arch), slots, max_len, page_len, shards=shards,
                   **kw)
    kw = dict(kw, shards=shards, device="cpu")
    pt = PagedKVCache(pt_smoke(arch), slots, max_len, page_len, **kw)
    local = [PagedKVCache(pt_smoke(arch), slots, max_len, page_len,
                          local_shard=d, **kw) for d in range(shards)]
    r = np.random.default_rng(seed)
    for b, leaf in pt.cache.items():
        span = pt.pools[b].shard_pages + 1
        for k, t in leaf.items():
            fill = torch.from_numpy(
                r.standard_normal(t.shape).astype(np.float32))
            t.copy_(fill)
            ref.cache[b][k] = jnp.asarray(fill.numpy(), ref.cache[b][k].dtype)
            for d, c in enumerate(local):
                c.cache[b][k].copy_(fill[:, d * span:(d + 1) * span])
    return ref, pt, local


def _agree(ref, pt, local, positions, where, pools=True):
    """After an op: equal allocator state, audits, reports and device
    tables; with ``pools``, the port's pools equal the reference's, and
    each local cache's pools the reference's chunk of its shard (only a
    fork writes them here)."""
    want = _state(ref)
    for c in (pt, *local):
        assert _state(c) == want, where
        c.audit()
    ref.audit()
    assert ref.report(positions=positions) == pt.report(positions=positions)
    for t1, t2 in zip(ref.tables().values(), pt.tables().values()):
        np.testing.assert_array_equal(np.asarray(t1), t2.numpy())
    if not pools:
        return
    for b, leaf in pt.cache.items():
        span = pt.pools[b].shard_pages + 1
        for k, t in leaf.items():
            full = np.asarray(ref.cache[b][k]).astype(np.float32)
            np.testing.assert_array_equal(full, t.float().numpy())
            for d, c in enumerate(local):
                np.testing.assert_array_equal(
                    full[:, d * span:(d + 1) * span],
                    c.cache[b][k].float().numpy())


def test_prefixes_stay_in_their_shard_and_fork_there():
    """A scripted sequence on gemma3-4b smoke (its windowed blocks ring
    over the prefix): a prompt cached by shard 0 misses from shard 1
    (salted chain) and hits from another slot of shard 0, whose ring
    then forks the shared page inside shard 0's range."""
    ref, pt, local = _caches("gemma3-4b", 4, 32, 4, 2, seed=5)
    caches = [ref, pt, *local]
    prompt = list(range(200, 230))
    def admit(slot):
        def op(c):
            assert c.reserve(30, slot=slot)
            return c.admit(slot, 30,
                           prefix=c.match_prefix(prompt, slot=slot)[1])
        return op

    ops = [admit(0), lambda c: c.ensure_range(0, 0, 8),
           lambda c: c.register_prefix(0, prompt, 8),
           admit(2), lambda c: c.ensure_range(2, 0, 8),
           lambda c: c.register_prefix(2, prompt, 8),
           admit(1), lambda c: c.ensure_range(1, 8, 24),
           lambda c: c.retire(0), lambda c: c.retire(1),
           lambda c: c.evict_one(shard=1), lambda c: c.retire(2),
           lambda c: c.flush_prefix()]
    for i, op in enumerate(ops):
        out, err = _each(caches, op)
        assert err is None, (i, err)
        _agree(ref, pt, local, [], i)
    assert pt.prefix_hits == 1 and pt.prefix_misses == 2
    assert pt.hit_tokens > 0 and pt.forks > 0 and pt.evictions > 0
    for p in pt.pools.values():
        assert not p.ref and p.committed_by == [0, 0]


@pytest.mark.parametrize("arch,page_len,shard_tokens", [
    ("gemma3-4b", 4, 24), ("olmo-1b", 8, None), ("olmo-1b", 8, 24)])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("strict", [True, False])
def test_sharded_allocator_matches_reference_op_for_op(arch, page_len,
                                                       shard_tokens, shards,
                                                       strict):
    """One seeded load of reserve(slot=) / admit(prefix=) / ensure /
    ensure_range / register_prefix / match_prefix(slot=) /
    evict_one(shard=) / retire / flush_prefix / confiscate /
    restore_held on the reference, the port and the port's per-shard
    caches.  After every op the tables, free lists (order included),
    refcounts, per-shard commitments, prefix chain (keys, owning shards,
    LRU order), the audit and the device tables agree, and each local
    cache's pools equal the reference's chunk of its shard."""
    slots, max_len = 8, 32
    # the pool bound grows with the shards: each shard's range stays
    # large enough to keep a prefix cached
    pool_tokens = shard_tokens and shard_tokens * shards
    ref, pt, local = _caches(arch, slots, max_len, page_len, shards,
                             seed=shards * 10 + page_len + strict,
                             pool_tokens=pool_tokens, strict=strict)
    caches = [ref, pt, *local]
    r = np.random.default_rng(shards + page_len)
    prompts = [list(range(100, 132)), list(range(100, 116)) + [7] * 16,
               [5] * 32]
    # admit, ensure, ensure_range, register, evict, retire, flush,
    # confiscate, restore: frequent retirements, so that prompts come
    # back to a shard that has cached them
    weights = np.array([3, 2, 4, 3, 1, 2.5, 0.3, 0.5, 0.5])
    active = {}                                # slot -> (prompt, pos)
    for step in range(160):
        forks = pt.forks
        op = int(r.choice(len(weights), p=weights / weights.sum()))
        free = [s for s in range(slots) if s not in active]
        if op == 0 and free:
            pr = prompts[int(r.integers(0, 3))]
            need = int(r.integers(4, 30 if strict else 12))
            # the first free slot whose shard has room, like the engine's
            # admission into the slot it will hand out
            slot = None
            for s in free:
                ok, _ = _each(caches, lambda c: c.reserve(need, slot=s))
                if ok:
                    slot = s
                    break
            if slot is None:
                continue
            found = [c.match_prefix(pr, slot=slot) for c in caches]
            assert all(m == found[0][0] for m, _ in found)
            reuse = bool(r.integers(0, 4))
            got = {c.admit(slot, need, prefix=blocks if reuse else None)
                   for c, (_, blocks) in zip(caches, found)}
            assert len(got) == 1
            active[slot] = (pr, got.pop())
        elif op in (1, 2) and active:
            slot = sorted(active)[int(r.integers(0, len(active)))]
            pr, pos = active[slot]
            n = 1 if op == 1 else int(r.integers(1, 9))
            _, err = _each(caches, (lambda c: c.ensure(slot, pos))
                           if op == 1 else
                           (lambda c: c.ensure_range(slot, pos, pos + n)))
            if err is None:
                active[slot] = (pr, pos + n)
        elif op == 3 and active:
            slot = sorted(active)[int(r.integers(0, len(active)))]
            pr, pos = active[slot]
            _each(caches, lambda c: c.register_prefix(slot, pr, pos))
        elif op == 4:
            prefer = [None, *pt.pools][int(r.integers(0, len(pt.pools) + 1))]
            shard = [None, *range(shards)][int(r.integers(0, shards + 1))]
            _each(caches, lambda c: c.evict_one(prefer=prefer, shard=shard))
        elif op == 5 and active:
            slot = sorted(active)[int(r.integers(0, len(active)))]
            _each(caches, lambda c: c.retire(slot))
            del active[slot]
        elif op == 6:
            _each(caches, lambda c: c.flush_prefix())
        elif op == 7:
            n = int(r.integers(0, 3))
            _each(caches, lambda c: c.confiscate(n))
        elif op == 8:
            _each(caches, lambda c: c.restore_held())
        _agree(ref, pt, local, [p for _, p in active.values()],
               (step, op), pools=pt.forks != forks)
    _agree(ref, pt, local, [p for _, p in active.values()], "end")
    assert pt.prefix_misses
    for slot in list(active):
        _each(caches, lambda c: c.retire(slot))
    _each(caches, lambda c: c.flush_prefix())
    _each(caches, lambda c: c.restore_held())
    for p in pt.pools.values():
        span = p.shard_pages + 1
        assert not p.ref and not p.held and p.committed_by == [0] * shards
        assert sorted(p.free) == [d * span + pg for d in range(shards)
                                  for pg in range(1, span)]


def test_one_shard_is_the_one_device_layout():
    """``shards=1`` keeps the one-device ids, free-list order and trash
    page 0 (the reference's claim, held on the port's cache)."""
    cfg = pt_smoke("olmo-1b")
    kv = PagedKVCache(cfg, 4, 32, 8, shards=1, device="cpu")
    for p in kv.pools.values():
        assert p.free == list(range(p.pool_pages, 0, -1))
        assert p.shard_pages == p.pool_pages and p.committed_by == [0]
        assert kv.cache[p.bname]["k"].shape[1] == p.pool_pages + 1
    local = PagedKVCache(cfg, 4, 32, 8, shards=2, local_shard=1,
                         device="cpu")
    for p in local.pools.values():
        assert local.cache[p.bname]["k"].shape[1] == p.shard_pages + 1
    # an idle slot's entries point at its own shard's trash page
    for t in local.tables().values():
        assert t[:2].eq(0).all() and t[2:].eq(
            next(iter(local.pools.values())).shard_pages + 1).all()

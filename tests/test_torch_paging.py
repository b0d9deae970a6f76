"""Port's paged KV cache against the JAX package's: the paged write and
gather layers, the paged layout and addressing, the host allocator
(``PagedKVCache``: tables, free lists, refcounts, commitments, prefix
cache, forks) driven op for op beside the reference's, and the prefill
planner's ``start=`` / ``cancel`` / ``audit``.

The layers and the allocator must agree exactly: page ids and free-list
order are integers, the written lines copies of the inputs.
"""
import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import layers as ref_L
from repro.models import model as ref_M
from repro.serve.errors import AuditViolation as RefAuditViolation
from repro.serve.paging import PagedKVCache as RefPaged
from repro.serve.prefill import PrefillPlanner as RefPlanner
from repro_torch.configs import get_config as pt_config
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.device import NoCudaDevice
from repro_torch.models import layers as pt_L
from repro_torch.models import model as pt_M
from repro_torch.serve import OutOfPages, PagedKVCache
from repro_torch.serve.errors import AuditViolation
from repro_torch.serve.prefill import PrefillPlanner

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SERVED = ["olmo-1b", "gemma3-4b", "gemma3-12b", "granite-moe-3b-a800m",
          "moonshot-v1-16b-a3b", "starcoder2-15b", "internvl2-76b",
          "musicgen-medium"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ layers ----


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_paged_kv_update_matches_reference(dname, masked):
    """Five rows write through a (5, 3) table into a 9-page pool: rows
    with mapped pages write their own line; an unmapped row and, with
    ``valid``, masked rows (one of them on a mapped, shared-looking
    page) land on the trash page 0 and leave every data page as it was.
    Data pages equal the reference's bit for bit."""
    r = np.random.default_rng(0)
    np_, plen, hkv, d = 9, 4, 2, 8
    pool_k = r.standard_normal((np_, plen, hkv, d)).astype(np.float32)
    pool_v = r.standard_normal((np_, plen, hkv, d)).astype(np.float32)
    k = r.standard_normal((5, 1, hkv, d)).astype(np.float32)
    v = r.standard_normal((5, 1, hkv, d)).astype(np.float32)
    table = np.array([[3, 7, 0], [1, 0, 0], [0, 0, 0], [5, 6, 2],
                      [8, 4, 0]], np.int32)
    slot = np.array([5, 2, 1, 9, 3], np.int32)    # row 2: unmapped page
    valid = np.array([True, False, True, True, False])
    jv = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    rk, rv = ref_L.paged_kv_update(
        jnp.asarray(pool_k, JDT[dname]), jnp.asarray(pool_v, JDT[dname]),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(slot), valid=jv)
    tk = torch.from_numpy(pool_k).to(TDT[dname])
    tvp = torch.from_numpy(pool_v).to(TDT[dname])
    before = tk.clone()
    out = pt_L.paged_kv_update(tk, tvp, torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(table).long(),
                               torch.from_numpy(slot).long(), valid=tv)
    assert out is None                        # written in place
    np.testing.assert_array_equal(_np(rk)[1:], _np(tk)[1:])
    np.testing.assert_array_equal(_np(rv)[1:], _np(tvp)[1:])
    live = valid if masked else np.ones(5, bool)
    live &= table[np.arange(5), slot // plen] != 0
    for row in range(5):
        pg = table[row, slot[row] // plen]
        line = tk[pg, slot[row] % plen]
        if live[row]:
            np.testing.assert_array_equal(
                _np(line), _np(torch.from_numpy(k[row, 0]).to(TDT[dname])))
        else:                                 # trash page took the row
            assert torch.equal(tk[pg, slot[row] % plen],
                               before[pg, slot[row] % plen]) or pg == 0
    # page 0 holds one of the rows routed there, at each touched line
    for off in {int(slot[i] % plen) for i in range(5) if not live[i]}:
        cands = [_np(torch.from_numpy(k[i, 0]).to(TDT[dname]))
                 for i in range(5) if not live[i] and slot[i] % plen == off]
        assert any(np.array_equal(_np(tk[0, off]), c) for c in cands)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_paged_gather_matches_reference(dname):
    r = np.random.default_rng(1)
    pool = r.standard_normal((7, 4, 2, 8)).astype(np.float32)
    table = np.array([[3, 0, 6], [1, 2, 4]], np.int32)
    ref = ref_L.paged_gather(jnp.asarray(pool, JDT[dname]),
                             jnp.asarray(table))
    pt = pt_L.paged_gather(torch.from_numpy(pool).to(TDT[dname]),
                           torch.from_numpy(table).long())
    assert pt.shape == (2, 12, 2, 8)
    np.testing.assert_array_equal(_np(ref), _np(pt))


# ------------------------------------------------------------ layout ----


@pytest.mark.parametrize("arch", SERVED)
def test_paged_layout_and_pool_shapes_match_reference(arch):
    """Every config the port serves, smoke and full: page-table widths,
    ring addressing and pool shapes (page 0 included) equal the
    reference's, for page lengths that do and do not divide the
    window."""
    for ref_cfg, cfg in ((ref_smoke(arch), pt_smoke(arch)),
                         (ref_config(arch), pt_config(arch))):
        for max_len, page_len in ((32, 8), (40, 3), (4096, 16)):
            layout = pt_M.paged_layout(cfg, max_len, page_len)
            assert layout == ref_M.paged_layout(ref_cfg, max_len, page_len)
            for i, blk in enumerate(cfg.pattern):
                slots = layout[f"b{i}"]
                assert pt_M.paged_addressing(slots, page_len, blk.window) \
                    == ref_M.paged_addressing(slots, page_len, blk.window)
            for pool_pages in (None, {b: 5 for b in layout}):
                ref = ref_M.cache_structs(ref_cfg, 3, max_len, page_len,
                                          pool_pages)
                for i, blk in enumerate(cfg.pattern):
                    shp = pt_M._cache_shapes(
                        cfg, blk, 3, max_len, page_len,
                        (pool_pages or {}).get(f"b{i}"))
                    assert {k: tuple(s) for k, s in shp.items()} == {
                        k: tuple(s.shape) for k, s in ref[f"b{i}"].items()}


def test_init_cache_paged_on_cpu():
    cfg = pt_smoke("gemma3-4b")
    cache = pt_M.init_cache(cfg, 2, 20, device="cpu", page_len=3)
    ref = ref_M.init_cache(ref_smoke("gemma3-4b"), 2, 20, page_len=3)
    for b, leaf in cache.items():
        for k, t in leaf.items():
            assert tuple(t.shape) == ref[b][k].shape and not t.any()


# --------------------------------------------------------- allocator ----


def _state(kv):
    """Everything the allocator decides, in comparable form."""
    pools = {b: (p.table.tolist(), list(p.free), dict(p.ref), p.committed,
                 p.in_use, p.peak, list(p.held), p.pool_pages,
                 p.page_slots, p.ring, p.capacity)
             for b, p in kv.pools.items()}
    prefix = [(e.key, e.parent, e.index, e.length, dict(e.pages),
               e.children) for e in kv.prefix.values()]
    counters = (kv.prefix_hits, kv.prefix_misses, kv.hit_tokens,
                kv.evictions, kv.forks, kv.resets, kv.shareable_tokens)
    return pools, prefix, counters, [dict(c) for c in kv._commit]


def _pools(kv):
    return {b: {k: _np(t) for k, t in leaf.items()}
            for b, leaf in kv.cache.items()}


def _call(fn):
    """(result, exception class name): OutOfPages and the strict
    commitment assertion are outcomes to compare, not failures."""
    try:
        return fn(), None
    except (AssertionError, RuntimeError) as e:
        return None, type(e).__name__


@pytest.mark.parametrize("arch,page_len,pool_tokens", [
    ("gemma3-4b", 4, 40), ("gemma3-4b", 3, None), ("olmo-1b", 8, 48)])
@pytest.mark.parametrize("strict", [True, False])
def test_allocator_matches_reference_op_for_op(arch, page_len, pool_tokens,
                                               strict):
    """One seeded sequence of reserve / admit(prefix=) / ensure /
    ensure_range / register_prefix / match_prefix / evict_one / retire /
    flush_prefix / confiscate / restore_held on both caches.  After
    every operation the tables, free lists (order included), refcounts,
    commitments, in_use / peak, prefix chain and LRU order are equal,
    the same operations raise, both audits pass, and the pools' bytes
    (forks copy pages on the device) are equal."""
    ref_cfg, cfg = ref_smoke(arch), pt_smoke(arch)
    slots, max_len = 3, 32
    ref = RefPaged(ref_cfg, slots, max_len, page_len,
                   pool_tokens=pool_tokens, strict=strict)
    pt = PagedKVCache(cfg, slots, max_len, page_len,
                      pool_tokens=pool_tokens, strict=strict, device="cpu")
    r = np.random.default_rng(len(arch) * 7 + page_len + strict)
    # distinct bytes in every page, so a fork's copy is checked
    for b, leaf in pt.cache.items():
        for k, t in leaf.items():
            fill = r.standard_normal(t.shape).astype(np.float32)
            t.copy_(torch.from_numpy(fill))
            ref.cache[b][k] = jnp.asarray(t.float().numpy(),
                                          ref.cache[b][k].dtype)
    prompts = [list(range(100, 132)), list(range(100, 116)) + [7] * 16,
               [5] * 32]
    # admit, ensure, ensure_range, register, evict, retire, flush,
    # confiscate, restore
    weights = np.array([3, 2, 4, 3, 1, 1, 0.3, 0.5, 0.5])
    active = {}                                # slot -> (prompt, pos)
    outcomes = []
    for step in range(200):
        op = int(r.choice(len(weights), p=weights / weights.sum()))
        free = [s for s in range(slots) if s not in active]
        if op == 0 and free:
            slot, pr = free[0], prompts[int(r.integers(0, 3))]
            # preemptible engines commit the live ingest only, so a
            # small reservation lets the pool run dry mid-flight
            need = int(r.integers(4, 30 if strict else 12))
            (ok, e1), (ok2, e2) = (_call(lambda: ref.reserve(need)),
                                   _call(lambda: pt.reserve(need)))
            assert (ok, e1) == (ok2, e2)
            if not ok:
                continue
            m1, b1 = ref.match_prefix(pr)
            m2, b2 = pt.match_prefix(pr)
            assert m1 == m2
            reuse = bool(r.integers(0, 4))
            s1 = ref.admit(slot, need, prefix=b1 if reuse else None)
            s2 = pt.admit(slot, need, prefix=b2 if reuse else None)
            assert s1 == s2
            active[slot] = (pr, s1)
        elif op in (1, 2) and active:
            slot = sorted(active)[int(r.integers(0, len(active)))]
            pr, pos = active[slot]
            if op == 1:
                res = (_call(lambda: ref.ensure(slot, pos)),
                       _call(lambda: pt.ensure(slot, pos)))
                n = 1
            else:
                n = int(r.integers(1, 9))
                res = (_call(lambda: ref.ensure_range(slot, pos, pos + n)),
                       _call(lambda: pt.ensure_range(slot, pos, pos + n)))
            assert res[0][1] == res[1][1], res
            outcomes.append(res[1][1])
            if res[1][1] is None:
                active[slot] = (pr, pos + n)
        elif op == 3 and active:
            slot = sorted(active)[int(r.integers(0, len(active)))]
            pr, pos = active[slot]
            ref.register_prefix(slot, pr, pos)
            pt.register_prefix(slot, pr, pos)
        elif op == 4:
            prefer = [None, *pt.pools][int(r.integers(0, len(pt.pools) + 1))]
            assert ref.evict_one(prefer=prefer) == pt.evict_one(prefer=prefer)
        elif op == 5 and active:
            slot = sorted(active)[int(r.integers(0, len(active)))]
            ref.retire(slot)
            pt.retire(slot)
            del active[slot]
        elif op == 6:
            assert ref.flush_prefix() == pt.flush_prefix()
        elif op == 7:
            n = int(r.integers(0, 3))
            assert ref.confiscate(n) == pt.confiscate(n)
        elif op == 8:
            assert ref.restore_held() == pt.restore_held()
        assert _state(ref) == _state(pt), (step, op)
        for b, leaf in _pools(pt).items():
            for k, t in leaf.items():
                np.testing.assert_array_equal(_np(ref.cache[b][k]), t)
        ref.audit()
        pt.audit()
        assert ref.report(positions=[p for _, p in active.values()]) == \
            pt.report(positions=[p for _, p in active.values()])
        assert ref.prefix_report() == pt.prefix_report()
        for t1, t2 in zip(ref.tables().values(), pt.tables().values()):
            assert t2.dtype == torch.int64
            np.testing.assert_array_equal(np.asarray(t1), t2.numpy())
    assert pt.evictions and (pt.prefix_hits or pt.forks)
    if not strict:
        assert "OutOfPages" in outcomes
    for slot in list(active):
        ref.retire(slot)
        pt.retire(slot)
    ref.flush_prefix(), pt.flush_prefix()
    pt.restore_held(), ref.restore_held()
    assert _state(ref) == _state(pt)
    for p in pt.pools.values():
        assert p.in_use == 0 and sorted(p.free) == list(
            range(1, p.pool_pages + 1))


def test_tables_upload_once_per_mapping_change():
    """The device tables are the same tensors until a mapping changes;
    the host tables stay int32, the device ones are int64."""
    kv = PagedKVCache(pt_smoke("olmo-1b"), 2, 32, 8, device="cpu")
    kv.reserve(20)
    kv.admit(0, 20)
    kv.ensure(0, 0)
    t = kv.tables()
    kv.ensure(0, 5)                             # same page: no change
    assert kv.tables() is t
    kv.ensure(0, 8)                             # a new page
    t2 = kv.tables()
    assert t2 is not t and all(v.dtype == torch.int64 for v in t2.values())
    assert all(p.table.dtype == np.int32 for p in kv.pools.values())
    kv.pools["b0"].table[1, 0] = 0              # host write: no aliasing
    assert int(t2["b0"][0, 1]) == int(kv.pools["b0"].table[0, 1])


def test_audit_catches_drift_like_the_reference():
    for cls, err in ((RefPaged, RefAuditViolation),
                     (PagedKVCache, AuditViolation)):
        kw = {} if cls is RefPaged else {"device": "cpu"}
        cfg = ref_smoke("olmo-1b") if cls is RefPaged else pt_smoke("olmo-1b")
        kv = cls(cfg, 2, 32, 8, **kw)
        kv.reserve(8)
        kv.admit(0, 8)
        kv.ensure(0, 0)
        kv.pools["b0"].ref[int(kv.pools["b0"].table[0, 0])] += 1
        with pytest.raises(err, match="refcount drift"):
            kv.audit()


def test_shards_and_device_are_explicit(monkeypatch):
    cfg = pt_smoke("olmo-1b")
    # data shards partition the slots; a count that does not divide
    # them is refused, as in the reference
    kv = PagedKVCache(cfg, 2, 32, 8, shards=2, device="cpu")
    assert kv.shards == 2 and [kv.slot_shard(s) for s in (0, 1)] == [0, 1]
    with pytest.raises(AssertionError):
        PagedKVCache(cfg, 3, 32, 8, shards=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        PagedKVCache(cfg, 2, 32, 8)
    assert issubclass(OutOfPages, RuntimeError)


# ----------------------------------------------------------- planner ----


def test_planner_start_cancel_audit_match_reference():
    ref, pt = RefPlanner(3, 4), PrefillPlanner(3, 4)
    for args in ((0, [1] * 9, 8),               # a full hit: no job
                 (0, list(range(10)), 6), (1, list(range(12)), 4),
                 (2, [1, 2, 3], 0)):
        assert ref.start(*args) == pt.start(*args)
    for _ in range(2):
        got, want = pt.next_call(), ref.next_call()
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]
    ref.cancel(1)
    pt.cancel(1)
    pt.cancel(1)                               # idempotent
    assert pt.report() == ref.report() and not pt.has_work
    pt.start(2, list(range(9)), 2)
    ref.start(2, list(range(9)), 2)
    pt.audit({2})
    ref.audit({2})
    with pytest.raises(AuditViolation, match="not active"):
        pt.audit({0})
    with pytest.raises(RefAuditViolation, match="not active"):
        ref.audit({0})
    pt._jobs[2].next = 99
    with pytest.raises(AuditViolation, match="cursor out of range"):
        pt.audit({2})

"""Port's paged model step against the JAX package's: ``decode_step``
and ``prefill_hidden`` through page tables on olmo-1b, gemma3-4b (a
page length that does not divide its window, so the ring runs over
padded capacity) and granite-moe smoke, and the port's paged step
against its own contiguous step, bit for bit.

Tolerances: float32 compute 1e-4; bfloat16 atol 2e-2·√d, rtol 1e-2.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as ref_M
from repro.serve.packed import pack_model as ref_pack_model
from repro.sparse.pruning import global_l1_prune as ref_prune
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import model as pt_M
from repro_torch.serve.packed import pack_model as pt_pack_model

ARCHS = ["olmo-1b", "gemma3-4b", "granite-moe-3b-a800m"]
# gemma3's smoke window is 8: page length 3 rounds its ring up to 9 lines
PAGE_LEN = {"olmo-1b": 8, "gemma3-4b": 3, "granite-moe-3b-a800m": 8}


def _tol(dname, d):
    if dname == "float32":
        return dict(atol=1e-4, rtol=1e-4)
    return dict(atol=2e-2 * np.sqrt(d), rtol=1e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().copy()
    return np.asarray(x, np.float32)


_ref_decode = jax.jit(ref_M.decode_step, static_argnums=(2,))
_ref_prefill = jax.jit(ref_M.prefill_hidden, static_argnums=(2,))


def _tables(layout, b, r):
    """Random page tables over the default pools: every entry of rows 0
    and 1 mapped to its own page, row 2's upper half unmapped (0)."""
    out = {}
    for bname, slots in layout.items():
        ids = r.permutation(np.arange(1, b * slots + 1)).astype(np.int32)
        t = ids.reshape(b, slots)
        t[2, slots // 2:] = 0
        out[bname] = t
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dname,packed", [("float32", False),
                                          ("float32", True),
                                          ("bfloat16", True)])
def test_paged_step_and_prefill_match_reference(arch, dname, packed):
    """Three decode steps, then two chunk calls (a padding lane, a lane
    past gemma3's window so the 9-line ring wraps), over pools filled
    with noise: logits, hidden states and every data page equal the
    reference's (page 0, the trash page, takes the masked lanes)."""
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype=dname)
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype=dname)
    params = jax.tree.map(np.asarray, ref_prune(
        ref_M.init_params(jax.random.PRNGKey(2), cfg), 0.5))
    pt_params = params_from_numpy(params, device="cpu")
    ref_pk = ref_pack_model(params).blocks if packed else None
    pt_pk = pt_pack_model(pt_params).blocks if packed else None
    b, max_len, c, plen = 3, 40, 4, PAGE_LEN[arch]
    r = np.random.default_rng(4)
    layout = pt_M.paged_layout(pcfg, max_len, plen)
    tables = _tables(layout, b, r)
    ref_tab = {k: jnp.asarray(t) for k, t in tables.items()}
    pt_tab = {k: torch.from_numpy(t).long() for k, t in tables.items()}
    pt_cache = pt_M.init_cache(pcfg, b, max_len, device="cpu",
                               page_len=plen)
    for leaf in pt_cache.values():
        for t in leaf.values():
            t.copy_(torch.from_numpy(r.standard_normal(t.shape).astype(
                np.float32)))
    ref_cache = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.dtype(dname)),
        pt_cache)
    tol = _tol(dname, cfg.d_model)

    def snapshot():
        return jax.tree.map(_np, pt_cache)

    def check_pools(before):
        for bname, leaf in pt_cache.items():
            for name, t in leaf.items():
                # page 0 is the trash page: duplicate writes, never read
                np.testing.assert_allclose(
                    _np(ref_cache[bname][name])[:, 1:], _np(t)[:, 1:],
                    **tol)
                # the pools start as noise far from any K/V line: a line
                # written in one and not the other fails the comparison
                assert np.any(_np(t)[:, 1:] != before[bname][name][:, 1:])

    step = build_serve_step(pcfg)
    for s in range(3):
        before = snapshot()
        tok = r.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        pos = np.array([s, 10 + s, 20 + s], np.int32)
        ref_logits, ref_cache = _ref_decode(
            params, ref_cache, cfg, jnp.asarray(tok), jnp.asarray(pos),
            packed=ref_pk, page_tables=ref_tab)
        _, logits, pt_cache = step(pt_params, pt_cache,
                                   torch.from_numpy(tok).long(),
                                   torch.from_numpy(pos).long(),
                                   packed=pt_pk, page_tables=pt_tab)
        np.testing.assert_allclose(_np(ref_logits), _np(logits), **tol)
        check_pools(before)
    prefill = build_prefill_step(pcfg)
    for pos, lens in ([[3, 13, 0], [4, 3, 0]], [[7, 16, 23], [4, 4, 2]]):
        before = snapshot()
        tok = r.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
        pos, lens = np.array(pos, np.int32), np.array(lens, np.int32)
        ref_h, ref_cache = _ref_prefill(
            params, ref_cache, cfg, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(lens), packed=ref_pk, page_tables=ref_tab)
        pt_h, pt_cache = prefill(pt_params, pt_cache,
                                 torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos).long(),
                                 torch.from_numpy(lens).long(),
                                 packed=pt_pk, page_tables=pt_tab)
        np.testing.assert_allclose(_np(ref_h), _np(pt_h), **tol)
        check_pools(before)


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-4b"])
def test_paged_step_equals_contiguous_step_bit_for_bit(arch):
    """The port's paged decode step, with each slot's pages mapped in
    order, serves the logits of its contiguous step exactly (bf16)."""
    cfg = pt_smoke(arch)
    params = pt_M.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    b, max_len = 2, 24
    plen = math.gcd(max_len, *(blk.window or max_len for blk in cfg.pattern))
    cont = pt_M.init_cache(cfg, b, max_len, device="cpu")
    paged = pt_M.init_cache(cfg, b, max_len, device="cpu", page_len=plen)
    layout = pt_M.paged_layout(cfg, max_len, plen)
    tables = {k: torch.arange(1, b * s + 1).reshape(b, s)
              for k, s in layout.items()}
    g = torch.Generator().manual_seed(1)
    for p in range(max_len + 6):            # the window rings wrap
        tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
        pos = torch.tensor([p, max(p - 3, 0)])
        want, _ = pt_M.decode_step(params, cont, cfg, tok,
                                   pos.clamp(max=max_len - 1))
        got, _ = pt_M.decode_step(params, paged, cfg, tok,
                                  pos.clamp(max=max_len - 1),
                                  page_tables=tables)
        assert torch.equal(want, got), p

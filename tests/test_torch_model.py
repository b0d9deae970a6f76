"""Port's decode-path layers and model against the JAX package, on the
same weights (bridged through numpy) and the same inputs.

Tolerances: float32 compute 1e-4; bfloat16 (the served type) atol
2e-2·√K, rtol 1e-2 — the kernels' tolerance, since the two frameworks
round bfloat16 intermediates at different places.
"""
import dataclasses

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke
from repro.models import layers as ref_L
from repro.models import model as ref_M
from repro.serve.engine import pack_lm_head as ref_pack_lm_head
from repro.serve.packed import pack_model as ref_pack_model
from repro.sparse.pruning import global_l1_prune as ref_prune
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.models import layers as pt_L
from repro_torch.models import model as pt_M
from repro_torch.serve.engine import pack_lm_head as pt_pack_lm_head
from repro_torch.serve.packed import pack_model as pt_pack_model

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dname, k):
    if dname == "float32":
        return dict(atol=1e-4, rtol=1e-4)
    return dict(atol=2e-2 * np.sqrt(k), rtol=1e-2)


def _pair(a, dname):
    return jnp.asarray(a, JDT[dname]), torch.from_numpy(a).to(TDT[dname])


def _close(ref, pt, **tol):
    np.testing.assert_allclose(np.asarray(ref, np.float32),
                               pt.float().numpy(), **tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "ln_nonparam", "ln"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_norm(kind, dname):
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 2, 64)).astype(np.float32)
    scale = 0.1 * r.standard_normal(64).astype(np.float32)
    (jx, tx), (js, ts) = _pair(x, dname), _pair(scale, "float32")
    _close(ref_L.norm(jx, js, kind), pt_L.norm(tx, ts, kind),
           **_tol(dname, 1))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_rope(dname):
    r = np.random.default_rng(1)
    x = r.standard_normal((3, 1, 4, 16)).astype(np.float32)
    pos = np.array([[0], [5], [1000]], np.int32)
    jx, tx = _pair(x, dname)
    _close(ref_L.rope(jx, jnp.asarray(pos), 10_000.0),
           pt_L.rope(tx, torch.from_numpy(pos), 10_000.0),
           **_tol(dname, 1))


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_activation(kind, dname):
    x = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    jx, tx = _pair(x, dname)
    _close(ref_L.activation(jx, kind), pt_L.activation(tx, kind),
           **_tol(dname, 1))


# (window, ring, cap) at the smoke heads (4 query / 2 KV, D 16), then at
# granite's grouping and head dim (g 3, D 64)
ATTN_CASES = [pytest.param(w, ring, cap, heads,
                           id=f"{w}-{ring}-{cap}" + ("" if heads[2] == 16
                                                     else "-g3-d64"))
              for heads in ((4, 2, 16), (6, 2, 64))
              for w, ring, cap in ((None, False, 12), (8, True, 8),
                                   (5, False, 12))]


@pytest.mark.parametrize("window,ring,cap,heads", ATTN_CASES)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_decode_attention_and_slot_write(window, ring, cap, heads, dname):
    r = np.random.default_rng(3)
    b, (hq, hkv, d) = 3, heads
    q = r.standard_normal((b, 1, hq, d)).astype(np.float32)
    kc = r.standard_normal((b, cap, hkv, d)).astype(np.float32)
    vc = r.standard_normal((b, cap, hkv, d)).astype(np.float32)
    kn = r.standard_normal((b, 1, hkv, d)).astype(np.float32)
    vn = r.standard_normal((b, 1, hkv, d)).astype(np.float32)
    pos = np.array([0, 6, 19], np.int32)
    slot = (pos % cap) if ring else np.clip(pos, 0, cap - 1)
    jq, tq = _pair(q, dname)
    (jk, tk), (jv, tv) = _pair(kc, dname), _pair(vc, dname)
    (jkn, tkn), (jvn, tvn) = _pair(kn, dname), _pair(vn, dname)
    jk, jv = ref_L.slot_kv_update(jk, jv, jkn, jvn, jnp.asarray(slot))
    pt_L.slot_kv_update(tk, tv, tkn, tvn, torch.from_numpy(slot).long())
    _close(jk, tk, atol=0, rtol=0)
    _close(jv, tv, atol=0, rtol=0)
    ref = ref_L.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                 window=window, ring=ring)
    pt = pt_L.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                               window=window, ring=ring)
    _close(ref, pt, **_tol(dname, d))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_mlp_dense_and_packed(dname):
    cfg = dataclasses.replace(ref_smoke("olmo-1b"), compute_dtype=dname)
    pcfg = dataclasses.replace(pt_smoke("olmo-1b"), compute_dtype=dname)
    r = np.random.default_rng(4)
    w = {n: (0.1 * r.standard_normal(s) * (r.random(s) > 0.5)).astype(
        np.float32) for n, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                                 ("w_down", (128, 64)))}
    x = r.standard_normal((2, 1, 64)).astype(np.float32)
    jx, tx = _pair(x, dname)
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    tw = {n: torch.from_numpy(a) for n, a in w.items()}
    from repro.sparse import pack_bitmap as ref_pack
    from repro_torch.sparse import pack_bitmap as pt_pack
    jp = {n: ref_pack(a, block=(64, 128) if n != "w_down" else (128, 64))
          for n, a in w.items()}
    tp = {n: pt_pack(t, block=(64, 128) if n != "w_down" else (128, 64))
          for n, t in tw.items()}
    tol = _tol(dname, 128)
    _close(ref_L.mlp(jw, jx, cfg), pt_L.mlp(tw, tx, pcfg), **tol)
    _close(ref_L.mlp(jw, jx, cfg, packed=jp), pt_L.mlp(tw, tx, pcfg,
                                                       packed=tp), **tol)


def _bridged(arch, dname, sparsity=0.5, seed=0):
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype=dname)
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype=dname)
    params = ref_prune(ref_M.init_params(jax.random.PRNGKey(seed), cfg),
                       sparsity)
    return cfg, pcfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-4b",
                                  "granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
def test_param_shapes_and_init_rules(arch):
    cfg, pcfg = ref_smoke(arch), pt_smoke(arch)
    ref_shapes = jax.tree.map(tuple, ref_M.param_shapes(cfg),
                              is_leaf=lambda x: isinstance(x, tuple))
    assert pt_M.param_shapes(pcfg) == ref_shapes
    gen = torch.Generator().manual_seed(0)
    pt = pt_M.init_params(gen, pcfg, device="cpu")
    ref = ref_M.init_params(jax.random.PRNGKey(0), cfg)
    flat_ref = {jax.tree_util.keystr(p): np.asarray(l)
                for p, l in jax.tree_util.tree_leaves_with_path(ref)}
    from repro_torch.sparse.pruning import keystr, tree_items
    for path, leaf in tree_items(pt):
        a = flat_ref[keystr(path)]
        assert tuple(leaf.shape) == a.shape and leaf.dtype == torch.float32
        if "norm" in keystr(path):
            assert not leaf.any() and not a.any()
        else:   # same scale rule: standard deviations agree to 25 %
            assert abs(float(leaf.std()) / float(a.std()) - 1) < 0.25


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-4b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_decode_step_logits_match(arch, packed, dname):
    """≥ 8 decode steps at per-slot positions (gemma3's sliding-window
    ring wraps; granite-moe's expert stacks through the grouped
    dispatch), packed and dense, logits and caches held step by step."""
    cfg, pcfg, params, pt_params = _bridged(arch, dname)
    ref_pk = pt_pk = ref_lm = pt_lm = None
    if packed:
        ref_pk = ref_pack_model(params).blocks
        pt_pk = pt_pack_model(pt_params).blocks
        ref_lm = ref_pack_lm_head(params, cfg, 0.5)
        pt_lm = pt_pack_lm_head(pt_params, pcfg, 0.5)
    b, max_len, steps = 3, 24, 12
    ref_cache = ref_M.init_cache(cfg, b, max_len)
    pt_cache = pt_M.init_cache(pcfg, b, max_len, device="cpu")
    step = jax.jit(ref_M.decode_step, static_argnums=(2,))
    r = np.random.default_rng(5)
    start = np.array([0, 3, 7], np.int32)
    tol = _tol(dname, cfg.d_model)
    for s in range(steps):
        tok = r.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        pos = start + s
        ref_logits, ref_cache = step(params, ref_cache, cfg,
                                     jnp.asarray(tok), jnp.asarray(pos),
                                     lm_weight=ref_lm, packed=ref_pk)
        pt_logits, pt_cache = pt_M.decode_step(
            pt_params, pt_cache, pcfg, torch.from_numpy(tok).long(),
            torch.from_numpy(pos).long(), lm_weight=pt_lm, packed=pt_pk)
        assert pt_logits.dtype == torch.float32
        _close(ref_logits, pt_logits, **tol)
    for bname, leaf in pt_cache.items():
        for k, t in leaf.items():
            _close(ref_cache[bname][k], t, **tol)

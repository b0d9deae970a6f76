"""The port's recurrent mixers against the JAX package: ``group_norm_heads``,
``mamba_decode``, ``rwkv_decode`` and the RWKV channel-mix module by
module (dense and with packed weights, several steps in a row with the
state carried), the decode cache's layout and types, and whole decode
steps of jamba and rwkv6 smoke against the reference's ``decode_step``
on ``pack_model`` blocks.

Tolerances: float32 atol 1e-5 + rtol 1e-5; bfloat16 (the served type)
atol 2e-2·√K, rtol 1e-2 (the kernels' tolerance, K the widest
contraction the value went through).  In float32 a decode step's greedy
tokens are identical.  In bfloat16 a step's argmax may differ only where
the reference's top-2 logit margin is within 2e-2·√d_model.
"""
import dataclasses
import functools

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
from repro.models import ssm as ref_ssm
from repro.serve.engine import pack_lm_head as ref_pack_lm_head
from repro.serve.packed import pack_model as ref_pack_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.kernels import bitmap_spmm as pt_kernel
from repro_torch.models import layers as pt_L
from repro_torch.models import model as pt_M
from repro_torch.models import ssm as pt_ssm
from repro_torch.serve.engine import pack_lm_head as pt_pack_lm_head
from repro_torch.serve.packed import pack_model as pt_pack_model
from repro_torch.sparse.pruning import global_l1_prune as pt_prune
from repro_torch.sparse.pruning import tree_map

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ("rwkv6-3b", "jamba-v0.1-52b")


def _tol(dname, k):
    if dname == "float32":
        return dict(atol=1e-5, rtol=1e-5)
    return dict(atol=2e-2 * np.sqrt(k), rtol=1e-2)


def _pair(a, dname):
    return jnp.asarray(a, JDT[dname]), torch.from_numpy(a).to(TDT[dname])


def _close(ref, pt, **tol):
    np.testing.assert_allclose(np.asarray(ref, np.float32),
                               pt.float().numpy(), **tol)


def _configs(arch, dname, **over):
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype=dname, **over)
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype=dname, **over)
    return cfg, pcfg


@functools.lru_cache(maxsize=None)
def _model(cfg, pcfg, sparsity, seed=0):
    """The same pruned params in both frameworks, and both packed block
    trees; shared by the tests, which never write them.  The weights are
    drawn and pruned by the port (its init follows the reference's
    per-name rules, and its pruning is held to the reference's in
    ``test_torch_format.py``), then carried to each side as numpy
    arrays: ``params_from_numpy`` for the port, ``jnp.asarray`` for the
    reference."""
    gen = torch.Generator().manual_seed(seed)
    pruned = pt_prune(pt_M.init_params(gen, pcfg, device="cpu"), sparsity)
    host = tree_map(lambda _, t: t.numpy(), pruned)
    params = jax.tree.map(jnp.asarray, host)
    pt_params = params_from_numpy(host, device="cpu")
    return (params, pt_params, ref_pack_model(params).blocks,
            pt_pack_model(pt_params).blocks)


def _block(cfg, pcfg, comp, packed):
    """Period 0 of block b0's ``comp`` at sparsity 0.5: (reference
    params, port params, reference packed, port packed) — packed None
    when dense."""
    params, pt_params, ref_pk, pt_pk = _model(cfg, pcfg, 0.5)
    rp = jax.tree.map(lambda a: a[0], params["blocks"]["b0"][comp])
    tp = pt_M._period(pt_params["blocks"]["b0"][comp], 0)
    if not packed:
        return rp, tp, None, None
    rk = jax.tree.map(lambda a: a[0], ref_pk["b0"][comp])
    tk = pt_M._period(pt_pk["b0"][comp], 0)
    assert {n for n, w in rk.items() if w is not None} == {
        n for n, w in tk.items() if w is not None}
    return rp, tp, rk, tk


# the reference's module functions, compiled (cfg is static)
REF_MAMBA = jax.jit(ref_ssm.mamba_decode, static_argnums=(3,))
REF_RWKV = jax.jit(ref_ssm.rwkv_decode, static_argnums=(3,))
REF_CM = jax.jit(ref_ssm.rwkv_channel_mix, static_argnums=(2,))
REF_STEP = jax.jit(ref_M.decode_step, static_argnums=(2,))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_group_norm_heads(dname):
    r = np.random.default_rng(0)
    x = (3.0 + r.standard_normal((3, 1, 64))).astype(np.float32)
    scale = (1 + 0.1 * r.standard_normal(64)).astype(np.float32)
    jx, tx = _pair(x, dname)
    out = pt_L.group_norm_heads(tx, torch.from_numpy(scale), 4)
    assert out.dtype == tx.dtype
    _close(ref_L.group_norm_heads(jx, jnp.asarray(scale), 4), out,
           **_tol(dname, 16))


@pytest.mark.parametrize("d_model", [64, 128])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_mamba_decode_steps(d_model, packed, dname):
    """Four steps in a row, each framework carrying its own state; at
    d_model 64 x_proj (128, 12) falls back to dense (no tile with
    BN % 8 divides 12) and dt_proj packs with BK = 4, at 128 x_proj
    (256, 16) packs too."""
    cfg, pcfg = _configs("jamba-v0.1-52b", dname, d_model=d_model)
    rp, tp, rk, tk = _block(cfg, pcfg, "mamba", packed)
    if packed:
        assert (tk.get("x_proj") is not None) == (d_model == 128)
        assert tk["dt_proj"].block == (cfg.mamba_dt_rank, 128)
    b, di, n = 3, cfg.mamba_d_inner, cfg.mamba_d_state
    r = np.random.default_rng(1)
    h0 = 0.1 * r.standard_normal((b, di, n)).astype(np.float32)
    c0 = r.standard_normal((b, cfg.mamba_conv - 1, di)).astype(np.float32)
    rs = {"h": jnp.asarray(h0), "conv": _pair(c0, dname)[0]}
    ts = {"h": torch.from_numpy(h0), "conv": _pair(c0, dname)[1]}
    tol = _tol(dname, di)
    for _ in range(4):
        jx, tx = _pair(r.standard_normal((b, 1, d_model)).astype(
            np.float32), dname)
        ro, rs = REF_MAMBA(rp, jx, rs, cfg, packed=rk)
        to, new = pt_ssm.mamba_decode(tp, tx, ts, pcfg, packed=tk)
        assert to.dtype == tx.dtype and new["h"].dtype == torch.float32
        assert new["conv"].dtype == tx.dtype
        _close(ro, to, **tol)
        for k in ("h", "conv"):
            _close(rs[k], new[k], **tol)
        ts = new


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_rwkv_decode_and_channel_mix_steps(packed, dname):
    """Four steps of the time-mix and the channel-mix, each framework
    carrying its own ``s``, ``x_prev`` and ``cm_x_prev``.  Packed, every
    projection is a bitmap weight (mix_A at BN 80, decay_B whose X is
    float32) and mix_B a 5-group stack."""
    cfg, pcfg = _configs("rwkv6-3b", dname)
    rp, tp, rk, tk = _block(cfg, pcfg, "rwkv", packed)
    rc, tc, rck, tck = _block(cfg, pcfg, "rwkv_cm", packed)
    if packed:
        assert tk["mix_mu"] is None and tck["cm_mu"] is None   # elementwise
        assert tk["mix_B"].values.dim() == 4 and tk["mix_A"].block == (64, 80)
        assert tk["decay_B"] is not None and tck["cm_v"] is not None
    b, d, h, hd = 3, cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    r = np.random.default_rng(2)
    s0 = 0.1 * r.standard_normal((b, h, hd, hd)).astype(np.float32)
    xp0 = r.standard_normal((b, d)).astype(np.float32)
    cp0 = r.standard_normal((b, d)).astype(np.float32)
    rs = {"s": jnp.asarray(s0), "x_prev": _pair(xp0, dname)[0]}
    ts = {"s": torch.from_numpy(s0), "x_prev": _pair(xp0, dname)[1]}
    rcp, tcp = _pair(cp0, dname)
    tol = _tol(dname, cfg.d_ff)
    for _ in range(4):
        jx, tx = _pair(r.standard_normal((b, 1, d)).astype(np.float32),
                       dname)
        ro, rs = REF_RWKV(rp, jx, rs, cfg, packed=rk)
        to, new = pt_ssm.rwkv_decode(tp, tx, ts, pcfg, packed=tk)
        assert to.dtype == tx.dtype and new["s"].dtype == torch.float32
        _close(ro, to, **tol)
        for k in ("s", "x_prev"):
            _close(rs[k], new[k], **tol)
        ts = new
        rco = REF_CM(rc, jx, cfg, x_prev=rcp[:, None], packed=rck)
        tco = pt_ssm.rwkv_channel_mix(tc, tx, tcp[:, None], packed=tck)
        _close(rco, tco, **tol)
        rcp, tcp = jx[:, 0], tx[:, 0]


def test_rwkv_dense_mix_b_branch_equals_grouped():
    """A mix_B that fell back (or was quarantined) takes the dense
    einsum; it computes what the grouped dispatch does."""
    _, tp, _, tk = _block(*_configs("rwkv6-3b", "float32"), "rwkv", True)
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((2, 1, 64)).astype(np.float32))
    xp = torch.from_numpy(r.standard_normal((2, 1, 64)).astype(np.float32))
    grouped = pt_ssm._rwkv_tokens(tp, x, xp, packed=tk)
    dense = pt_ssm._rwkv_tokens(tp, x, xp, packed={**tk, "mix_B": None})
    for a, b in zip(grouped, dense):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_softplus_is_logaddexp_past_20():
    x = torch.tensor([-30.0, 0.0, 19.0, 25.0, 80.0])
    np.testing.assert_allclose(pt_ssm.softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(x.numpy())),
                               rtol=1e-6)


@pytest.mark.parametrize("arch,page_len", [("rwkv6-3b", 0),
                                           ("jamba-v0.1-52b", 0),
                                           ("jamba-v0.1-52b", 8)])
def test_init_cache_layout_and_types(arch, page_len):
    """Leaves, shapes and types are the reference's ``cache_structs``:
    ``h`` and ``s`` float32, every other leaf the compute type; mamba
    state stays slotted when jamba's attention pages."""
    cfg, pcfg = ref_smoke(arch), pt_smoke(arch)
    ref = ref_M.cache_structs(cfg, 3, 32, page_len=page_len)
    pt = pt_M.init_cache(pcfg, 3, 32, device="cpu", page_len=page_len)
    assert set(pt) == set(ref)
    for bname, leaf in pt.items():
        assert set(leaf) == set(ref[bname]), bname
        for k, t in leaf.items():
            assert tuple(t.shape) == ref[bname][k].shape, (bname, k)
            want = torch.float32 if k in ("h", "s") else torch.bfloat16
            assert t.dtype == want and not t.any(), (bname, k)
            assert str(ref[bname][k].dtype) == str(want).split(".")[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference(arch):
    cfg, pcfg = ref_smoke(arch), pt_smoke(arch)
    ref_shapes = jax.tree.map(tuple, ref_M.param_shapes(cfg),
                              is_leaf=lambda x: isinstance(x, tuple))
    assert pt_M.param_shapes(pcfg) == ref_shapes


def _steps(arch, dname, slots, sparsity, steps=8, greedy=True):
    """``steps`` decode steps of both frameworks on the same pruned
    params, packed as the engines pack them (``pack_model`` blocks and
    the per-tensor-pruned head), per-slot positions; ``greedy`` feeds
    each framework its own argmax, else both the same random tokens.
    Yields (reference logits, port logits) per step, then checks the
    caches."""
    cfg, pcfg = _configs(arch, dname)
    params, pt_params, ref_pk, pt_pk = _model(cfg, pcfg, sparsity)
    ref_lm = ref_pack_lm_head(params, cfg, sparsity)
    pt_lm = pt_pack_lm_head(pt_params, pcfg, sparsity)
    max_len = 24
    ref_cache = ref_M.init_cache(cfg, slots, max_len)
    pt_cache = pt_M.init_cache(pcfg, slots, max_len, device="cpu")
    r = np.random.default_rng(slots)
    start = np.arange(slots, dtype=np.int32) * 2
    tok = r.integers(0, cfg.vocab_size, (slots, 1)).astype(np.int32)
    pt_tok = tok
    for s in range(steps):
        pos = start + s
        ref_logits, ref_cache = REF_STEP(params, ref_cache, cfg,
                                     jnp.asarray(tok), jnp.asarray(pos),
                                     lm_weight=ref_lm, packed=ref_pk)
        pt_logits, pt_cache = pt_M.decode_step(
            pt_params, pt_cache, pcfg, torch.from_numpy(pt_tok).long(),
            torch.from_numpy(pos).long(), lm_weight=pt_lm, packed=pt_pk)
        yield np.asarray(ref_logits), pt_logits.numpy()
        if greedy:
            tok = np.asarray(ref_logits).argmax(-1)[:, None].astype(np.int32)
            pt_tok = pt_logits.argmax(-1)[:, None].numpy().astype(np.int32)
        else:
            tok = pt_tok = r.integers(0, cfg.vocab_size,
                                      (slots, 1)).astype(np.int32)
    tol = _tol(dname, cfg.d_ff)
    for bname, leaf in pt_cache.items():
        for k, t in leaf.items():
            _close(ref_cache[bname][k], t, **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("sparsity", [0.0, 0.5])
def test_decode_steps_greedy_tokens_identical_in_float32(arch, slots,
                                                         sparsity):
    """Eight greedy steps: identical tokens, logits within 1e-5 + 1e-5·|x|
    (the caches, checked after the last step, too)."""
    for ref_logits, pt_logits in _steps(arch, "float32", slots, sparsity):
        np.testing.assert_array_equal(ref_logits.argmax(-1),
                                      pt_logits.argmax(-1))
        np.testing.assert_allclose(ref_logits, pt_logits, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_bf16_near_tie_rule(arch):
    """Eight teacher-forced steps in bfloat16: logits within 2e-2·√d_ff,
    and the argmax differs only at a reference near tie."""
    cfg = ref_smoke(arch)
    tol = 2e-2 * np.sqrt(cfg.d_model)
    for ref_logits, pt_logits in _steps(arch, "bfloat16", 4, 0.5,
                                        greedy=False):
        np.testing.assert_allclose(ref_logits, pt_logits,
                                   **_tol("bfloat16", cfg.d_ff))
        for row, (a, b) in enumerate(zip(ref_logits.argmax(-1),
                                         pt_logits.argmax(-1))):
            if a != b:
                top2 = np.sort(ref_logits[row])[-2:]
                assert top2[1] - top2[0] <= tol, (row, top2)


def test_counter_buffers_are_per_stream():
    """K1's split-K fold counters: one buffer per (device, stream), so
    launches on two streams never share counters; a stream's buffer is
    reused until a call needs more."""
    dev = torch.device("cpu")
    a = pt_kernel.counters(dev, 8, stream=101)
    assert pt_kernel.counters(dev, 8, stream=101) is a
    b = pt_kernel.counters(dev, 8, stream=202)
    assert b is not a and b.data_ptr() != a.data_ptr()
    big = pt_kernel.counters(dev, a.numel() + 1, stream=101)
    assert big.numel() > a.numel() and not big.any()
    assert pt_kernel.counters(dev, 8, stream=202) is b
    for key in ((dev, 101), (dev, 202)):
        pt_kernel._COUNTERS.pop(key)

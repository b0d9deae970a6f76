"""Port's baseline mode (``REPRO_PERF_MODE=baseline``,
``models/perf_flags.py``) and the ``REPRO_MOE_EP`` override against the
JAX package's.

Baseline mode switches the reference back to its pre-optimisation
lowering: the global-argsort MoE dispatch (``_moe_ffn_global``), GQA
over materialised repeated KV heads, the loss chunk without
``checkpoint`` and tensor-parallel MoE rules with Adam moments laid out
like the params.  The port has a branch for the dispatch and the specs,
resolved once where a step or a spec is built; each is held to the
reference's branch on the same inputs (the reference called unjitted,
since it reads the variable at trace time).  Repeated KV and the
un-checkpointed loss give the default values, so the port keeps one path
for each, held here to both of the reference's branches.  Tolerances:
float32, 1e-5 (the same products summed in another order).
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

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import sharding as ref_shd
from repro.models import layers as ref_L
from repro.models.model import init_params as ref_init_params
from repro.models.model import lm_loss as ref_lm_loss
from repro.serve.packed import pack_model as ref_pack_model
from repro.sparse.pruning import global_l1_prune as ref_prune
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.launch import sharding as shd
from repro_torch.launch.steps import _batch_rows, build_eval_step
from repro_torch.models import layers as pt_L
from repro_torch.models.model import lm_loss
from repro_torch.models.perf_flags import baseline_mode
from repro_torch.serve.packed import pack_model as pt_pack_model
from test_torch_shard_rules import _fake_mesh, _flat, _ref_flat

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def baseline(monkeypatch):
    monkeypatch.setenv("REPRO_PERF_MODE", "baseline")
    assert baseline_mode()


def _period0(tree):
    return {k: (None if v is None else v.period(0) if hasattr(v, "period")
                else v[0]) for k, v in tree.items()}


@functools.lru_cache(maxsize=1)
def _moe_params(cfg):
    return jax.tree.map(np.asarray, ref_prune(
        ref_init_params(jax.random.PRNGKey(3), cfg), 0.5))


def _moe_inputs(packed):
    """moonshot smoke (8 experts, top 2; its router packs) in float32 at
    capacity factor 1, pruned 0.5; period 0's MoE params (and packs) for
    both sides, and x of 4 rows x 3 tokens."""
    cfg = dataclasses.replace(ref_smoke("moonshot-v1-16b-a3b"),
                              compute_dtype="float32", capacity_factor=1.0)
    pcfg = dataclasses.replace(pt_smoke("moonshot-v1-16b-a3b"),
                               compute_dtype="float32", capacity_factor=1.0)
    params = _moe_params(cfg)
    pt_params = params_from_numpy(params, device="cpu")
    ref_p = jax.tree.map(lambda a: a[0], params["blocks"]["b0"]["moe"])
    pt_p = _period0(pt_params["blocks"]["b0"]["moe"])
    ref_pk = pt_pk = None
    if packed:
        ref_pk = jax.tree.map(lambda a: a[0],
                              ref_pack_model(params).blocks["b0"]["moe"])
        pt_pk = _period0(pt_pack_model(pt_params).blocks["b0"]["moe"])
    x = np.random.default_rng(5).standard_normal(
        (4, 3, cfg.d_model)).astype(np.float32)
    return cfg, pcfg, ref_p, pt_p, ref_pk, pt_pk, x


@pytest.mark.parametrize("packed", [False, True])
def test_global_dispatch_matches_reference(packed):
    """``_moe_ffn_global`` equals the reference's, dense and through the
    packed stacks (K1g's plain version here); at this batch the global
    capacity drops other tokens than per-row dispatch, so the two
    dispatches' outputs differ."""
    cfg, pcfg, ref_p, pt_p, ref_pk, pt_pk, x = _moe_inputs(packed)
    ref = ref_L._moe_ffn_global(ref_p, jnp.asarray(x), cfg, packed=ref_pk,
                                impl="xla" if packed else None)
    got = pt_L._moe_ffn_global(pt_p, torch.from_numpy(x), pcfg,
                               packed=pt_pk)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    rows = pt_L.moe_ffn(pt_p, torch.from_numpy(x), pcfg, packed=pt_pk)
    assert not np.allclose(rows.numpy(), got.numpy(), atol=1e-3), \
        "global and per-row capacity dropped the same tokens"


def test_moe_ffn_dispatches_globally_in_baseline_mode(monkeypatch):
    """``moe_ffn(global_dispatch=True)`` is the reference's ``moe_ffn``
    in baseline mode.  A step built under ``REPRO_PERF_MODE=baseline``
    takes the global dispatch in every MoE block, read once at build
    time (the variable cleared before the call); a step built without
    the variable dispatches per row and gives another loss.  (The
    sharded-training world holds a baseline-mode moonshot step to the
    reference's, ``tests/test_torch_spmd_train.py``.)"""
    cfg, pcfg, ref_p, pt_p, _, _, x = _moe_inputs(False)
    xt = torch.from_numpy(x)
    default = pt_L.moe_ffn(pt_p, xt, pcfg)
    calls = []
    real = pt_L._moe_ffn_global

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pt_L, "_moe_ffn_global", spy)
    got = pt_L.moe_ffn(pt_p, xt, pcfg, global_dispatch=True)
    monkeypatch.setenv("REPRO_PERF_MODE", "baseline")
    ref = ref_L.moe_ffn(ref_p, jnp.asarray(x), cfg)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert not np.allclose(got.numpy(), default.numpy(), atol=1e-3)

    params = _moe_params(cfg)
    r = np.random.default_rng(6)
    batch = {k: r.integers(0, cfg.vocab_size, (4, 6))
             for k in ("tokens", "targets")}
    step = build_eval_step(pcfg)
    monkeypatch.delenv("REPRO_PERF_MODE")
    pt_params = params_from_numpy(params, device="cpu")
    pt_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls.clear()
    loss = float(step(pt_params, pt_batch)["loss"])
    moe_blocks = sum(b.ffn == "moe" for b in pcfg.pattern) * pcfg.num_periods
    assert len(calls) == moe_blocks > 0
    calls.clear()
    rows = float(build_eval_step(pcfg)(pt_params, pt_batch)["loss"])
    assert calls == [] and abs(rows - loss) > 1e-5, (rows, loss)


def _gqa(seed, shape_q, shape_kv):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("window", [None, 8])
def test_scan_attention_repeated_kv(monkeypatch, window):
    """GQA (4 query heads over 2 KV heads): the port's grouped path
    equals the reference's default branch and its baseline branch over
    materialised repeated KV, so the port needs no second path."""
    q, k, v = _gqa(0, (2, 24, 4, 16), (2, 24, 2, 16))
    pos = np.broadcast_to(np.arange(24), (2, 24)).copy()
    kw = dict(window=window, q_chunk=8, kv_chunk=8)
    got = pt_L.scan_attention(*(torch.from_numpy(a)
                                for a in (q, k, v, pos)), **kw)
    j = [jnp.asarray(a) for a in (q, k, v, pos)]
    default = ref_L.scan_attention(*j, **kw)
    monkeypatch.setenv("REPRO_PERF_MODE", "baseline")
    ref = ref_L.scan_attention(*j, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(default), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_repeated_kv(monkeypatch, ring):
    q, k, v = _gqa(1, (3, 1, 4, 16), (3, 12, 2, 16))
    pos = np.array([2, 7, 30])
    kw = dict(window=12 if ring else None, ring=ring)
    got = pt_L.decode_attention(*(torch.from_numpy(a)
                                  for a in (q, k, v, pos)), **kw)
    j = [jnp.asarray(a) for a in (q, k, v, pos)]
    default = ref_L.decode_attention(*j, **kw)
    monkeypatch.setenv("REPRO_PERF_MODE", "baseline")
    ref = ref_L.decode_attention(*j, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(default), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_lm_loss_without_checkpoint_and_its_gradients(monkeypatch):
    """The reference's un-checkpointed chunked loss (baseline mode) and
    its checkpointed one: the port's one ``lm_loss`` gives both's loss
    and gradients of the hidden states and the (tied) head (chunk 8 over
    20 positions, so the tail is padded; a few targets masked)."""
    cfg = dataclasses.replace(ref_smoke("olmo-1b"), compute_dtype="float32",
                              loss_chunk=8)
    pcfg = dataclasses.replace(pt_smoke("olmo-1b"), compute_dtype="float32",
                               loss_chunk=8)
    params = jax.tree.map(np.asarray,
                          ref_init_params(jax.random.PRNGKey(4), cfg))
    r = np.random.default_rng(2)
    hidden = r.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    targets = r.integers(0, cfg.vocab_size, (2, 20))
    targets[0, :3] = -1

    embed = torch.tensor(params["embed"], requires_grad=True)
    h = torch.from_numpy(hidden).requires_grad_(True)
    loss, m = lm_loss({"embed": embed}, h, torch.from_numpy(targets), pcfg)
    gh, ge = torch.autograd.grad(loss, (h, embed))

    def ref_fn(embed, h):
        return ref_lm_loss({"embed": embed}, h, jnp.asarray(targets), cfg)

    def ref_run():
        return jax.value_and_grad(ref_fn, argnums=(0, 1), has_aux=True)(
            jnp.asarray(params["embed"]), jnp.asarray(hidden))

    default = ref_run()
    monkeypatch.setenv("REPRO_PERF_MODE", "baseline")
    for (ref_loss, ref_m), (ref_ge, ref_gh) in (default, ref_run()):
        assert m["tokens"].item() == float(ref_m["tokens"]) == 37
        assert loss.item() == pytest.approx(float(ref_loss), rel=1e-5)
        np.testing.assert_allclose(gh.numpy(), np.asarray(ref_gh), **TOL)
        np.testing.assert_allclose(ge.numpy(), np.asarray(ref_ge), **TOL)


FLAGS = [("REPRO_MOE_EP", "0"), ("REPRO_MOE_EP", "1"),
         ("REPRO_PERF_MODE", "baseline")]


@pytest.mark.parametrize("var,value", FLAGS)
def test_specs_equal_reference_under_flags(monkeypatch, var, value):
    """``param_specs`` (train and serve) and ``opt_specs`` equal the
    reference's on every arch at full config over fake meshes, with each
    flag set; each flag changes some arch's specs from the default."""
    changed = False
    for data, model in ((2, 4), (16, 16)):
        mesh = _fake_mesh(data, model)
        for arch in ARCHS:
            cfg, rcfg = get_config(arch), ref_config(arch)
            default = (_flat(shd.param_specs(cfg, mesh)),
                       _flat(shd.param_specs(cfg, mesh, serve=True)),
                       _flat(shd.opt_specs(cfg, mesh)["m"]))
            monkeypatch.setenv(var, value)
            got = (_flat(shd.param_specs(cfg, mesh)),
                   _flat(shd.param_specs(cfg, mesh, serve=True)),
                   _flat(shd.opt_specs(cfg, mesh)["m"]))
            want = (_ref_flat(ref_shd.param_specs(rcfg, mesh)),
                    _ref_flat(ref_shd.param_specs(rcfg, mesh, serve=True)),
                    _ref_flat(ref_shd.opt_specs(rcfg, mesh)["m"]))
            monkeypatch.delenv(var)
            assert got == want, (arch, data, model)
            if var == "REPRO_PERF_MODE":
                # the flag passed in gives what the variable gives
                assert got == (
                    _flat(shd.param_specs(cfg, mesh, baseline=True)),
                    _flat(shd.param_specs(cfg, mesh, serve=True,
                                          baseline=True)),
                    _flat(shd.opt_specs(cfg, mesh, baseline=True)["m"])), \
                    arch
            changed |= got != default
    assert changed, (var, value)


def test_baseline_moments_follow_params_and_global_moe_takes_whole_batch(
        baseline):
    """Baseline mode: the moments' specs are the params' (no ZeRO-1), and
    a data rank of a sharded train step takes the whole batch when the
    model has MoE blocks and the step dispatches globally (the global
    capacity ranks every token)."""
    mesh = _fake_mesh(4, 1)
    cfg = get_config("olmo-1b")
    assert shd.opt_specs(cfg, mesh)["m"] == shd.param_specs(cfg, mesh)
    assert shd.opt_specs(cfg, mesh, baseline=False)["m"] != \
        shd.param_specs(cfg, mesh, baseline=False)

    class Rank:
        data, model, data_rank = 2, 1, 1
        batch, batch_rank = 2, 1           # the batch axes: data alone
        shape = {"data": 2, "model": 1}
        axis_names = ("data", "model")

    batch = {"targets": torch.zeros(8, 4, dtype=torch.int64)}
    moe = pt_smoke("moonshot-v1-16b-a3b")
    assert _batch_rows(batch, pt_smoke("olmo-1b"), Rank, True) == (4, 8)
    assert _batch_rows(batch, moe, Rank, True) is None
    assert _batch_rows(batch, moe, Rank, False) == (4, 8)

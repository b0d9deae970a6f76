"""Port's MoE path against the JAX package's, on the same (bridged)
weights: ``moe_ffn`` dense and packed, the top-k tie order, the combine's
summation order, and the serving engine on granite-moe and moonshot
smoke (granite's 64×5 router has no bitmap tile and falls back;
moonshot's 64×8 one packs).

Tolerances: float32 compute 1e-5 (the same products summed in another
order); bfloat16 atol 2e-2·√d, rtol 1e-2 (the kernels' tolerance).
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
from repro.models.model import init_params as ref_init_params
from repro.serve import ServeEngine as RefEngine
from repro.serve import poisson_trace
from repro.serve.packed import pack_model as ref_pack_model
from repro.sparse.pruning import global_l1_prune as ref_prune
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.models import layers as pt_L
from repro_torch.serve import ServeEngine as PtEngine
from repro_torch.serve.packed import pack_model as pt_pack_model

ARCHS = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dname, d):
    if dname == "float32":
        return dict(atol=1e-5, rtol=1e-5)
    return dict(atol=2e-2 * np.sqrt(d), rtol=1e-2)


def _moe_params(arch, dname, sparsity=0.5):
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype=dname)
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype=dname)
    params = jax.tree.map(np.asarray, ref_prune(
        ref_init_params(jax.random.PRNGKey(1), cfg), sparsity))
    return cfg, pcfg, params, params_from_numpy(params, device="cpu")


_ref_moe = jax.jit(ref_L.moe_ffn, static_argnums=(2,),
                   static_argnames=("impl",))


def _period0(tree):
    return {k: (None if v is None else v.period(0) if hasattr(v, "period")
                else v[0]) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_moe_ffn_matches_reference(arch, dname, packed):
    cfg, pcfg, params, pt_params = _moe_params(arch, dname)
    ref_p = jax.tree.map(lambda a: a[0], params["blocks"]["b0"]["moe"])
    pt_p = _period0(pt_params["blocks"]["b0"]["moe"])
    ref_pk = pt_pk = None
    if packed:
        ref_pk = jax.tree.map(lambda a: a[0],
                              ref_pack_model(params).blocks["b0"]["moe"])
        pt_pk = _period0(pt_pack_model(pt_params).blocks["b0"]["moe"])
        assert pt_pk["w_gate"].values.dim() == 4       # (E, KT, NT, budget)
    for b, s in [(1, 1), (4, 1), (1, 3), (4, 3)]:
        x = np.random.default_rng(10 * b + s).standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
        ref = _ref_moe(ref_p, jnp.asarray(x, JDT[dname]), cfg,
                       packed=ref_pk, impl="xla" if packed else None)
        pt = pt_L.moe_ffn(pt_p, torch.from_numpy(x).to(TDT[dname]), pcfg,
                          packed=pt_pk)
        assert pt.dtype == TDT[dname] and pt.shape == (b, s, cfg.d_model)
        np.testing.assert_allclose(np.asarray(ref, np.float32),
                                   pt.float().numpy(),
                                   **_tol(dname, cfg.d_model))


def test_top_k_ties_break_toward_lower_index():
    """Exact ties (two identical router columns, a zero column) pick the
    lower expert first, as ``jax.lax.top_k`` does — and ``moe_ffn``
    routes the tied tokens to the same experts as the reference."""
    probs = np.array([[0.1, 0.3, 0.1, 0.3, 0.2],
                      [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3):
        rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
        pv, pi = pt_L.top_k_lower_index(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
        np.testing.assert_array_equal(np.asarray(rv), pv.numpy())

    cfg, pcfg, params, _ = _moe_params("moonshot-v1-16b-a3b", "float32",
                                       sparsity=0.0)
    moe = jax.tree.map(lambda a: np.array(a[0]),
                       params["blocks"]["b0"]["moe"])
    moe["router"][:, 5] = moe["router"][:, 2]          # experts 2 and 5 tie
    moe["router"][:, 6] = 0.0
    moe["router"][:, 7] = 0.0                          # 6 and 7 tie at 0
    x = np.random.default_rng(0).standard_normal(
        (3, 2, cfg.d_model)).astype(np.float32)
    logits = x @ moe["router"]
    assert (logits[..., 2] == logits[..., 5]).all()
    ref = ref_L.moe_ffn(jax.tree.map(jnp.asarray, moe), jnp.asarray(x), cfg)
    pt = pt_L.moe_ffn({k: torch.from_numpy(v) for k, v in moe.items()},
                      torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(np.asarray(ref), pt.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("b,s,k,cap", [(2, 3, 2, 2), (4, 1, 8, 1),
                                       (1, 16, 6, 3)])
def test_combine_sums_in_the_reference_order(b, s, k, cap):
    """The combine in float32, bit for bit: the reference's
    ``out.at[rows, src].add(contrib · gval)`` (updates sorted by expert)
    against the port's fixed ascending-expert sum, on the same expert
    outputs, gates and routing."""
    e, d = 8, 16
    r = np.random.default_rng(b * 100 + s)
    expert_idx = np.stack([r.permutation(e)[:k] for _ in range(b * s)]
                          ).reshape(b, s, k)
    gate = r.random((b, s, k)).astype(np.float32)
    y = (r.standard_normal((b, e * cap, d)) * 10).astype(np.float32)

    flat_e = expert_idx.reshape(b, s * k)
    order = np.argsort(flat_e, axis=-1, kind="stable")
    sorted_e = np.take_along_axis(flat_e, order, axis=-1)
    first = np.stack([np.searchsorted(row, row, side="left")
                      for row in sorted_e])
    rank = np.arange(s * k)[None, :] - first
    keep = rank < cap
    slot = sorted_e * cap + np.where(keep, rank, 0)
    src = order // k
    # the reference's combine, verbatim
    rows = jnp.arange(b)[:, None]
    out_tok = jnp.take_along_axis(jnp.asarray(y), slot[..., None], axis=1)
    gval = jnp.take_along_axis(jnp.asarray(gate).reshape(b, s * k), order,
                               axis=-1)
    contrib = jnp.where(keep[..., None], out_tok, 0).astype(jnp.float32)
    ref = jnp.zeros((b, s, d), jnp.float32).at[rows, src].add(
        contrib * gval[..., None])
    pt = pt_L.moe_combine(torch.from_numpy(y), torch.from_numpy(slot),
                          torch.from_numpy(keep), torch.from_numpy(order),
                          torch.from_numpy(gate),
                          torch.from_numpy(expert_idx))
    assert pt.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ref), pt.numpy())


def _rows(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _serve(engine, trace):
    """Run the trace; record each decoding slot's logits by (rid, pos)."""
    log = {}
    decode = engine._decode

    def recording(*args):
        out = decode(*args)
        logits = _rows(out[1])
        for slot, req in engine.scheduler.active.items():
            log[(req.rid, int(engine._pos[slot]))] = logits[slot]
        return out

    engine._decode = recording
    reqs = [engine.submit(**spec) for spec in trace]
    rep = engine.run()
    return reqs, log, rep


def _engines(arch, slots, sparsity, dname):
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype=dname)
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype=dname)
    ref = RefEngine(cfg, num_slots=slots, max_len=32, sparsity=sparsity,
                    seed=0)
    params = jax.tree.map(np.asarray,
                          ref_init_params(jax.random.PRNGKey(0), cfg))
    pt = PtEngine(pcfg, num_slots=slots, max_len=32, sparsity=sparsity,
                  seed=0, params=params_from_numpy(params, device="cpu"),
                  device="cpu")
    trace = poisson_trace(6, rate=0.8, seed=7, vocab_size=cfg.vocab_size,
                          max_new=(6, 12))
    return ref, pt, trace


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("sparsity", [0.0, 0.5])
def test_moe_engine_matches_reference_engine(arch, slots, sparsity):
    """Served tokens, the manifest (grouped expert layouts; granite's
    router falls back with the reference's reason, moonshot's packs) and
    the modeled bytes with the activated-expert accounting.  In bfloat16
    a request may part from the reference only where the reference's
    own top-2 margin is within the logit tolerance."""
    ref, pt, trace = _engines(arch, slots, sparsity, "bfloat16")
    ref_reqs, ref_log, ref_rep = _serve(ref, trace)
    pt_reqs, pt_log, pt_rep = _serve(pt, trace)

    assert len(ref.packed.manifest) == len(pt.packed.manifest)
    for a, b in zip(ref.packed.manifest, pt.packed.manifest):
        assert (a.path, tuple(a.shape), a.packed, a.reason, a.block,
                a.sparsity, a.sparse_bytes, a.dense_bytes, a.layout,
                a.experts) == (
            b.path, b.shape, b.packed, b.reason, b.block, b.sparsity,
            b.sparse_bytes, b.dense_bytes, b.layout, b.experts)
    layouts = {e.path.split("/")[-1]: e for e in pt.packed.manifest
               if "/moe/" in e.path}
    for name in ("w_gate", "w_up", "w_down"):
        assert layouts[name].layout == "grouped"
        assert layouts[name].experts == pt.cfg.num_experts
    router = layouts["router"]
    if arch.startswith("granite"):
        assert not router.packed and "no (BK, BN) tile" in router.reason
    else:
        assert router.packed and router.layout == "stacked"
    for key in ("weight_sparsity", "head_compression", "head_fallback",
                "requests", "generated_tokens"):
        assert ref_rep[key] == pt_rep[key], key
    for key in ("sparse_bytes_per_step", "dense_bytes_per_step",
                "reduction", "packed_tensors", "fallback_tensors",
                "fallbacks", "activated_experts",
                "device_sparse_bytes_per_step",
                "device_dense_bytes_per_step"):
        assert ref_rep["weight_stream"][key] == pt_rep["weight_stream"][
            key], key
    assert pt_rep["weight_stream"]["activated_experts"] == \
        slots * pt.cfg.top_k

    tol = 2e-2 * np.sqrt(ref.cfg.d_model)
    for rr, rp in zip(ref_reqs, pt_reqs):
        assert len(rp.tokens) == rp.max_new_tokens
        if rr.tokens == rp.tokens:
            continue
        i = next(j for j, (a, b) in enumerate(zip(rr.tokens, rp.tokens))
                 if a != b)
        p = len(rr.prompt) - 1 + i
        row = ref_log[(rr.rid, p)]
        top2 = np.sort(row)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin <= tol, (
            f"rid {rr.rid} parts at token {i} (pos {p}) with reference "
            f"top-2 margin {margin:.4f} > {tol:.4f}")
        np.testing.assert_allclose(pt_log[(rp.rid, p)], row, atol=tol,
                                   rtol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_engine_tokens_identical_in_float32(arch):
    ref, pt, trace = _engines(arch, 4, 0.5, "float32")
    ref_reqs, _, ref_rep = _serve(ref, trace)
    pt_reqs, _, pt_rep = _serve(pt, trace)
    assert [r.tokens for r in ref_reqs] == [r.tokens for r in pt_reqs]
    assert pt_rep["requests"] == len(trace)


def test_dense_dispatch_counts_activated_experts():
    """``stream_weights=False``: the dense baseline's modeled bytes
    scale the expert stacks the same way as the reference's."""
    ref, pt, _ = _engines("granite-moe-3b-a800m", 2, 0.0, "float32")
    cfg = ref.cfg
    params = jax.tree.map(np.asarray,
                          ref_init_params(jax.random.PRNGKey(0), cfg))
    ref_d = RefEngine(cfg, num_slots=2, max_len=32, seed=0,
                      stream_weights=False)
    pt_d = PtEngine(pt.cfg, num_slots=2, max_len=32, seed=0,
                    params=params_from_numpy(params, device="cpu"),
                    stream_weights=False,
                    device="cpu")
    a, b = ref_d.weight_stream_report(), pt_d.weight_stream_report()
    for key in ("sparse_bytes_per_step", "dense_bytes_per_step",
                "activated_experts", "fallbacks"):
        assert a[key] == b[key], key

"""Port's chunked prefill (contiguous cache) against the JAX package's:
``prefill_hidden`` hidden states and cache on olmo-1b, gemma3-4b
(sliding windows and the ring) and granite-moe smoke, padding lanes
writing nothing; the engine with ``prefill_chunk`` against the
reference engine; and the port's chunked engine against its own prompt
walk.

Tolerances: float32 compute 1e-4; bfloat16 atol 2e-2·√d, rtol 1e-2.
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
from repro.models import model as ref_M
from repro.serve import ServeEngine as RefEngine
from repro.serve import poisson_trace
from repro.serve.packed import pack_model as ref_pack_model
from repro.sparse.pruning import global_l1_prune as ref_prune
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import model as pt_M
from repro_torch.serve import ServeEngine as PtEngine
from repro_torch.serve.engine import prefill_fallback
from repro_torch.serve.packed import pack_model as pt_pack_model
from repro_torch.serve.prefill import PrefillPlanner

ARCHS = ["olmo-1b", "gemma3-4b", "granite-moe-3b-a800m"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dname, d):
    if dname == "float32":
        return dict(atol=1e-4, rtol=1e-4)
    return dict(atol=2e-2 * np.sqrt(d), rtol=1e-2)


_ref_decode = jax.jit(ref_M.decode_step, static_argnums=(2,))
_ref_prefill = jax.jit(ref_M.prefill_hidden, static_argnums=(2,))


def _close(ref, pt, **tol):
    np.testing.assert_allclose(np.asarray(ref, np.float32),
                               pt.float().numpy(), **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dname,packed", [("float32", False),
                                          ("float32", True),
                                          ("bfloat16", True)])
def test_prefill_hidden_matches_reference(arch, dname, packed):
    """Two chunk calls over a cache that decode steps already wrote:
    slot 0 starts a prompt, slot 1 continues one past gemma3's window
    (the ring wraps), slot 2 is a padding lane (lens = 0) in the first
    call and a short chunk in the second."""
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype=dname)
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype=dname)
    params = jax.tree.map(np.asarray, ref_prune(
        ref_M.init_params(jax.random.PRNGKey(2), cfg), 0.5))
    pt_params = params_from_numpy(params, device="cpu")
    ref_pk = ref_pack_model(params).blocks if packed else None
    pt_pk = pt_pack_model(pt_params).blocks if packed else None
    b, max_len, c = 3, 40, 4
    ref_cache = ref_M.init_cache(cfg, b, max_len)
    pt_cache = pt_M.init_cache(pcfg, b, max_len, device="cpu")
    r = np.random.default_rng(3)
    for s in range(3):          # some cache lines already written
        tok = r.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        pos = np.array([s, 10 + s, 20 + s], np.int32)
        _, ref_cache = _ref_decode(params, ref_cache, cfg,
                                   jnp.asarray(tok), jnp.asarray(pos),
                                   packed=ref_pk)
        pt_M.decode_step(pt_params, pt_cache, pcfg,
                         torch.from_numpy(tok).long(),
                         torch.from_numpy(pos).long(), packed=pt_pk)
    prefill = build_prefill_step(pcfg)
    tol = _tol(dname, cfg.d_model)
    for pos, lens in ([[3, 13, 0], [4, 3, 0]], [[7, 16, 23], [4, 4, 2]]):
        tok = r.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
        pos, lens = np.array(pos, np.int32), np.array(lens, np.int32)
        before = {k: {n: t.clone() for n, t in v.items()}
                  for k, v in pt_cache.items()}
        ref_h, ref_cache = _ref_prefill(
            params, ref_cache, cfg, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(lens), packed=ref_pk)
        pt_h, pt_cache = prefill(pt_params, pt_cache,
                                 torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos).long(),
                                 torch.from_numpy(lens).long(),
                                 packed=pt_pk)
        assert pt_h.shape == (b, c, cfg.d_model)
        _close(ref_h, pt_h, **tol)
        for bname, leaf in pt_cache.items():
            for name, t in leaf.items():
                _close(ref_cache[bname][name], t, **tol)
                if lens[2] == 0:          # the padding lane wrote nothing
                    assert torch.equal(t[:, 2], before[bname][name][:, 2])


def _engines(arch, slots, chunk, dname="float32", sparsity=0.5):
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype=dname)
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype=dname)
    ref = RefEngine(cfg, num_slots=slots, max_len=48, sparsity=sparsity,
                    seed=0, prefill_chunk=chunk)
    params = jax.tree.map(np.asarray,
                          ref_M.init_params(jax.random.PRNGKey(0), cfg))
    pt = PtEngine(pcfg, num_slots=slots, max_len=48, sparsity=sparsity,
                  seed=0, params=params_from_numpy(params, device="cpu"),
                  prefill_chunk=chunk, device="cpu")
    trace = poisson_trace(6, rate=0.8, seed=5, vocab_size=cfg.vocab_size,
                          prompt_len=(2, 14), max_new=(4, 10))
    return ref, pt, trace


def _run(engine, trace):
    reqs = [engine.submit(**spec) for spec in trace]
    return reqs, engine.run()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [0, 4])
def test_engine_prefill_matches_reference_engine(arch, chunk):
    """float32 compute: tokens identical to the reference engine's, and
    the prefill section's accounting equal."""
    ref, pt, trace = _engines(arch, 4, chunk)
    ref_reqs, ref_rep = _run(ref, trace)
    pt_reqs, pt_rep = _run(pt, trace)
    assert [r.tokens for r in ref_reqs] == [r.tokens for r in pt_reqs]
    assert all(len(r.tokens) == r.max_new_tokens for r in pt_reqs)
    for key in ("enabled", "fallback", "prefill_steps", "decode_steps",
                "chunk", "calls", "tokens_prefilled", "in_flight",
                "lane_utilization"):
        assert ref_rep["prefill"][key] == pt_rep["prefill"][key], key
    if chunk:
        assert pt_rep["prefill"]["calls"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slots,sparsity", [(2, 0.0), (4, 0.5)])
def test_chunked_engine_serves_the_prompt_walks_tokens(arch, slots,
                                                       sparsity):
    """The port's chunked engine against the port's prompt walk, float32:
    identical tokens, in fewer decode steps."""
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype="float32")
    trace = poisson_trace(6, rate=0.8, seed=11, vocab_size=pcfg.vocab_size,
                          prompt_len=(2, 20), max_new=(3, 8))
    runs = {}
    for chunk in (0, 3, 8):
        eng = PtEngine(pcfg, num_slots=slots, max_len=48,
                       sparsity=sparsity, seed=4, prefill_chunk=chunk,
                       device="cpu")
        runs[chunk] = _run(eng, trace)
    walk = [r.tokens for r in runs[0][0]]
    for chunk in (3, 8):
        assert [r.tokens for r in runs[chunk][0]] == walk, chunk
        pf = runs[chunk][1]["prefill"]
        assert pf["enabled"] and pf["calls"] > 0 and pf["in_flight"] == 0
        assert runs[chunk][1]["prefill"]["decode_steps"] < \
            runs[0][1]["prefill"]["decode_steps"]


def test_planner_cuts_prompts_into_padded_calls():
    planner = PrefillPlanner(num_slots=3, chunk=4)
    assert not planner.start(0, [7])              # one token: decode only
    assert planner.start(1, list(range(10)))      # 9 positions to prefill
    assert planner.start(2, [5, 6, 7])
    tok, pos, lens, done = planner.next_call()
    assert tok.shape == (3, 4) and list(lens) == [0, 4, 2]
    assert list(pos) == [0, 0, 0] and done == [2]
    assert list(tok[1]) == [0, 1, 2, 3] and list(tok[2][:2]) == [5, 6]
    assert planner.in_prefill(1) and planner.next_pos(1) == 4
    tok, pos, lens, done = planner.next_call()
    assert list(lens) == [0, 4, 0] and list(pos) == [0, 4, 0] and done == []
    tok, pos, lens, done = planner.next_call()
    assert list(lens) == [0, 1, 0] and done == [1]
    assert not planner.has_work
    assert planner.report() == {"chunk": 4, "calls": 3,
                                "tokens_prefilled": 11, "in_flight": 0,
                                "lane_utilization": 11 / 36}


def test_prefill_fallback_reasons_match_reference():
    """Recurrent mixers and the frames frontend keep the prompt walk,
    with the reference engine's reason; attention archs have none."""
    for arch in ("rwkv6-3b", "musicgen-medium"):
        ref = RefEngine(ref_smoke(arch), num_slots=2, max_len=16,
                        prefill_chunk=4)
        assert prefill_fallback(pt_smoke(arch)) == ref.prefill_fallback
    for arch in ARCHS:
        assert prefill_fallback(pt_smoke(arch)) is None


def test_cli_prefill_chunk(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu",
          "--sparsity", "0.5", "--requests", "3", "--prefill-chunk", "2"])
    out = capsys.readouterr().out
    assert "3 requests" in out and "chunked prefill:" in out

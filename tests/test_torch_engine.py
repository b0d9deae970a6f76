"""Port's ServeEngine against the JAX package's ServeEngine, engine
against engine, on the same (bridged) weights and the same trace.

In float32 compute the served tokens must be identical.  In bfloat16 (the
served type) a request may part from the reference only at a step where
the reference's own top-2 logit margin is within the logit tolerance
(2e-2·√d_model) — a near tie the two frameworks' rounding can break
either way; the test finds that step and shows the margin.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import init_params as ref_init_params
from repro.serve import ServeEngine as RefEngine
from repro.serve import poisson_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.device import NoCudaDevice
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.serve import ServeEngine as PtEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def _pair(slots, sparsity, dname, seed=0, max_len=32):
    cfg = dataclasses.replace(ref_smoke("olmo-1b"), compute_dtype=dname)
    pcfg = dataclasses.replace(pt_smoke("olmo-1b"), compute_dtype=dname)
    ref = RefEngine(cfg, num_slots=slots, max_len=max_len, sparsity=sparsity,
                    seed=seed)
    params = jax.tree.map(np.asarray,
                          ref_init_params(jax.random.PRNGKey(seed), cfg))
    pt = PtEngine(pcfg, num_slots=slots, max_len=max_len, sparsity=sparsity,
                  seed=seed, params=params_from_numpy(params, device="cpu"),
                  device="cpu")
    trace = poisson_trace(6, rate=0.8, seed=7, vocab_size=cfg.vocab_size,
                          max_new=(6, 12))
    return ref, pt, trace


@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.75])
def test_engine_matches_reference_engine(slots, sparsity):
    ref, pt, trace = _pair(slots, sparsity, "bfloat16")
    ref_reqs, ref_log, ref_rep = _serve(ref, trace)
    pt_reqs, pt_log, pt_rep = _serve(pt, trace)

    # what packed or fell back, and why; the modeled bytes
    assert len(ref.packed.manifest) == len(pt.packed.manifest)
    for a, b in zip(ref.packed.manifest, pt.packed.manifest):
        assert (a.path, tuple(a.shape), a.packed, a.reason, a.block,
                a.sparsity, a.sparse_bytes, a.dense_bytes, a.layout) == (
            b.path, b.shape, b.packed, b.reason, b.block, b.sparsity,
            b.sparse_bytes, b.dense_bytes, b.layout)
    for key in ("weight_sparsity", "head_compression", "head_fallback",
                "requests", "generated_tokens"):
        assert ref_rep[key] == pt_rep[key], key
    for key in ("sparse_bytes_per_step", "dense_bytes_per_step",
                "reduction", "packed_tensors", "fallback_tensors",
                "fallbacks"):
        assert ref_rep["weight_stream"][key] == pt_rep["weight_stream"][
            key], key

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


@pytest.mark.parametrize("slots,sparsity", [(2, 0.5), (4, 0.75)])
def test_engine_tokens_identical_in_float32(slots, sparsity):
    ref, pt, trace = _pair(slots, sparsity, "float32")
    ref_reqs, _, _ = _serve(ref, trace)
    pt_reqs, _, pt_rep = _serve(pt, trace)
    assert [r.tokens for r in ref_reqs] == [r.tokens for r in pt_reqs]
    assert pt_rep["requests"] == len(trace)


def test_sampling_depends_only_on_seed_and_position():
    """A sampled request's tokens do not depend on which other requests
    share the batch; top_k=1 sampling is greedy."""
    cfg = pt_smoke("olmo-1b")
    solo = PtEngine(cfg, num_slots=2, max_len=32, seed=1, device="cpu")
    a = solo.submit([5, 6], max_new_tokens=8, temperature=0.8, seed=42)
    solo.run()
    busy = PtEngine(cfg, num_slots=2, max_len=32, seed=1, device="cpu")
    busy.submit([9], max_new_tokens=12)
    b = busy.submit([5, 6], max_new_tokens=8, temperature=0.8, seed=42,
                    arrival=3)
    g = busy.submit([5, 6], max_new_tokens=8)
    k1 = busy.submit([5, 6], max_new_tokens=8, temperature=0.8, top_k=1)
    busy.run()
    assert a.tokens == b.tokens
    assert k1.tokens == g.tokens


def _sampled_trace(vocab, per_request_top_k):
    """Staggered arrivals, half greedy and half sampled at T 0.8 / 1.0;
    with ``per_request_top_k`` the sampled requests name their own top-k
    (0 or 3: the per-slot vector), else they take the engine's."""
    rng = np.random.default_rng(5)
    trace = []
    for i in range(6):
        spec = dict(prompt=[int(t) for t in rng.integers(1, vocab, 2 + i)],
                    max_new_tokens=6, arrival=float(2 * (i // 2)))
        if i % 2:
            spec.update(temperature=(0.8, 1.0)[(i // 2) % 2], seed=40 + i)
            if per_request_top_k:
                spec["top_k"] = (0, 3)[(i // 2) % 2]
        trace.append(spec)
    return trace


SAMPLED = [("olmo-1b", 0, True), ("olmo-1b", 5, False),
           ("granite-moe-3b-a800m", 0, True)]


@pytest.mark.parametrize("arch,top_k,per_request", SAMPLED,
                         ids=["olmo-per-request", "olmo-engine-wide",
                              "granite-per-request"])
def test_sampled_tokens_equal_reference_engine(arch, top_k, per_request):
    """Sampled requests (T > 0) draw the reference's
    ``jax.random.categorical`` from ``PRNGKey(seed)`` folded with the
    slot's position, replayed on the device by ``repro_torch.prng``: in
    float32 every token, greedy and sampled, equals the reference
    engine's (run outside its mesh), with per-request and engine-wide
    top-k."""
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype="float32")
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype="float32")
    kw = dict(num_slots=3, max_len=32, sparsity=0.5, seed=0, top_k=top_k)
    params = jax.tree.map(np.asarray,
                          ref_init_params(jax.random.PRNGKey(0), cfg))
    ref = RefEngine(cfg, **kw)
    pt = PtEngine(pcfg, params=params_from_numpy(params, device="cpu"),
                  device="cpu", **kw)
    trace = _sampled_trace(cfg.vocab_size, per_request)
    tokens = []
    for eng in (ref, pt):
        reqs = [eng.submit(**spec) for spec in trace]
        eng.run()
        tokens.append([[int(t) for t in r.tokens] for r in reqs])
    assert tokens[1] == tokens[0]
    assert pt._use_sampling and pt._use_topk_vec == per_request
    greedy = [t for t, spec in zip(tokens[1], trace)
              if not spec.get("temperature")]
    sampled = [t for t, spec in zip(tokens[1], trace)
               if spec.get("temperature")]
    assert greedy and sampled and all(len(t) == 6 for t in tokens[1])


def test_engine_rejects_and_counts():
    eng = PtEngine(pt_smoke("olmo-1b"), num_slots=2, max_len=16,
                   device="cpu")
    from repro_torch.serve import RequestRejected
    for bad in (dict(prompt=[], max_new_tokens=2),
                dict(prompt=[1], max_new_tokens=0),
                dict(prompt=[1] * 10, max_new_tokens=8),
                dict(prompt=[256], max_new_tokens=2)):
        with pytest.raises(RequestRejected):
            eng.submit(**bad)
    reset_launches()
    eng.submit([1, 2, 3], max_new_tokens=4)
    rep = eng.run()
    # CPU tensors take the plain version: no kernel launch, and the
    # dense renderings exist only here, never on the card
    assert LAUNCHES["bitmap_spmm"] == 0
    assert eng.lm_weight.dense_cache is not None
    assert rep["requests"] == 1 and rep["cache_resets"] == 1
    assert eng.decode_steps == 2 + 4


def test_frames_frontend_serves_reference_tokens():
    """musicgen's frames frontend: every decode step's embeddings come
    from ``PRNGKey(seed + 0x5eed)`` folded with the step counter, which
    the port replays (``repro_torch.prng``).  On the same weights, in
    float32, with staggered arrivals (so slots idle and refill and the
    step counter fast-forwards), the tokens equal the reference engine's
    (run outside its mesh)."""
    cfg = dataclasses.replace(ref_smoke("musicgen-medium"),
                              compute_dtype="float32")
    pcfg = dataclasses.replace(pt_smoke("musicgen-medium"),
                               compute_dtype="float32")
    kw = dict(num_slots=3, max_len=32, sparsity=0.5, seed=2)
    ref = RefEngine(cfg, **kw)
    params = jax.tree.map(np.asarray,
                          ref_init_params(jax.random.PRNGKey(2), cfg))
    pt = PtEngine(pcfg, params=params_from_numpy(params, device="cpu"),
                  device="cpu", **kw)
    trace = [dict(prompt=[1, 2, 3], max_new_tokens=6, arrival=0.0),
             dict(prompt=[5], max_new_tokens=8, arrival=2.0),
             dict(prompt=[7, 8], max_new_tokens=5, arrival=3.0),
             dict(prompt=[9, 1, 2, 3, 4], max_new_tokens=6, arrival=5.0),
             dict(prompt=[6], max_new_tokens=3, arrival=30.0)]
    tokens = []
    for eng in (ref, pt):
        reqs = [eng.submit(**spec) for spec in trace]
        eng.run()
        tokens.append([[int(t) for t in r.tokens] for r in reqs])
    assert tokens[1] == tokens[0]
    assert [len(t) for t in tokens[1]] == [6, 8, 5, 6, 3]
    # the idle gap fast-forwards the step counter past the last arrival
    assert pt._steps == ref._steps >= 30


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
def test_bridge_carries_moe_leaves_unchanged(arch):
    """The router (P, d, E) and the expert stacks (P, E, d, f) cross the
    bridge with their paths, shapes, types and values."""
    cfg = ref_smoke(arch)
    params = jax.tree.map(np.asarray,
                          ref_init_params(jax.random.PRNGKey(0), cfg))
    pt = params_from_numpy(params, device="cpu")
    moe, pt_moe = params["blocks"]["b0"]["moe"], pt["blocks"]["b0"]["moe"]
    p, d, e, f = cfg.num_periods, cfg.d_model, cfg.num_experts, cfg.d_ff
    assert moe["router"].shape == (p, d, e)
    assert moe["w_gate"].shape == (p, e, d, f)
    assert moe["w_down"].shape == (p, e, f, d)
    assert set(pt_moe) == set(moe)
    for name, a in moe.items():
        b = pt_moe[name]
        assert b.dtype == torch.float32 and b.is_contiguous()
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_no_device_given_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        PtEngine(pt_smoke("olmo-1b"))
    from repro_torch.launch.serve import main
    with pytest.raises(NoCudaDevice):
        main(["--arch", "olmo-1b", "--smoke"])


@pytest.mark.parametrize("entry", ["params_from_numpy", "init_params",
                                   "init_cache", "SlotKVCache"])
def test_tensor_makers_default_to_card_and_raise_without_it(monkeypatch,
                                                           entry):
    """The functions that build the port's tensors run on ``cuda``
    unless given a device: without a card they raise, never drop to the
    CPU."""
    from repro_torch.models import model as pt_M
    from repro_torch.serve.cache import SlotKVCache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt_smoke("olmo-1b")
    calls = {
        "params_from_numpy": lambda: params_from_numpy(
            {"w": np.zeros((2, 3), np.float32)}),
        "init_params": lambda: pt_M.init_params(
            torch.Generator().manual_seed(0), cfg),
        "init_cache": lambda: pt_M.init_cache(cfg, 2, 8),
        "SlotKVCache": lambda: SlotKVCache(cfg, 2, 8),
    }
    with pytest.raises(NoCudaDevice):
        calls[entry]()


def test_port_imports_without_jax_or_reference():
    """Every module of the port imports with ``jax`` and ``repro``
    blocked, and a CPU engine serves a step."""
    code = """
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
from repro_torch.configs import get_smoke_config
from repro_torch.serve import ServeEngine
eng = ServeEngine(get_smoke_config("olmo-1b"), num_slots=2, max_len=16,
                  sparsity=0.5, device="cpu")
req = eng.submit([3], max_new_tokens=1)
eng.step()
assert len(req.tokens) == 1, req.tokens
print(len(names), "modules")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "modules" in out.stdout

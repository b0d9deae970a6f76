"""The port's full-sequence forward and loss against the JAX package:
``scan_attention``, the full-sequence mixers, MoE at training length,
``forward``, ``lm_loss`` / ``loss_fn`` and their gradients; and the
port's ``decode_step`` reproducing its own ``forward`` token by token.

Every arch runs one period of its smoke config (``num_layers =
len(pattern)``) in float32, on the port's seeded init handed to the
reference through numpy.  Two periods are cut to one block of each
kind they hold, to keep the reference's compile short (jamba's whole
8-block period takes ~22 s): jamba to its blocks 2-3 (mamba + MLP,
attention + MoE), gemma3 to its blocks 1-2 (windowed and global
attention).

Tolerances:
- ``scan_attention``: float32 atol/rtol 1e-5; bfloat16 atol 5e-2,
  rtol 1e-2 (its gradient, float32: atol/rtol 1e-5).
- ``forward`` (and the mixers, MoE): float32 atol/rtol 1e-4.
- ``loss_fn`` / ``lm_loss``: relative 1e-5.
- gradients of ``loss_fn`` against ``jax.grad``: per leaf, max |diff| <=
  1e-4·max|ref| + 1e-7.
- ``decode_step`` against ``forward`` (port only): atol/rtol 2e-2, the
  reference's own test of this property.
"""
import dataclasses

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synth_batch as ref_synth_batch
from repro.models import layers as ref_L
from repro.models import model as ref_M
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import loss_and_grads
from repro_torch.launch.train import to_device
from repro_torch.models import layers as pt_L
from repro_torch.models import model as pt_M
from repro_torch.models import ssm as pt_ssm
from repro_torch.sparse.pruning import tree_items
from test_torch_threads import one_torch_thread  # noqa: F401  (fixture)

ARCHS = ("olmo-1b", "granite-moe-3b-a800m", "gemma3-4b", "rwkv6-3b",
         "jamba-v0.1-52b", "musicgen-medium", "internvl2-76b")
F32 = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def one_period(arch: str, **over):
    """The port's smoke config of ``arch`` cut to one period (jamba's
    and gemma3's to two blocks), float32; the reference's config is built
    from the same fields (``ref_config``)."""
    cfg = get_smoke_config(arch)
    cut = {"jamba-v0.1-52b": slice(2, 4), "gemma3-4b": slice(1, 3)}
    if arch in cut:
        cfg = dataclasses.replace(cfg, pattern=cfg.pattern[cut[arch]])
    return dataclasses.replace(cfg, num_layers=len(cfg.pattern),
                               compute_dtype="float32", **over)


def ref_config(cfg):
    """The reference's ``ModelConfig`` with the port config's fields."""
    from repro.models.config import BlockCfg as RB
    from repro.models.config import ModelConfig as RM
    from repro.models.config import SparsityCfg as RS
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["pattern"] = tuple(RB(**dataclasses.asdict(b))
                              for b in cfg.pattern)
    fields["sparsity"] = RS(**dataclasses.asdict(cfg.sparsity))
    return RM(**fields)


def seeded_params(cfg, seed: int = 0):
    """(port params on the CPU, the same values as a reference tree)."""
    gen = torch.Generator().manual_seed(seed)
    pt = pt_M.init_params(gen, cfg, device="cpu")
    return pt, to_ref(pt)


def to_ref(tree):
    if isinstance(tree, dict):
        return {k: to_ref(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


def close_grads(ref_grads, pt_grads):
    """Per leaf: max |diff| <= 1e-4·max|ref| + 1e-7."""
    want = dict(tree_items(jax.tree.map(np.asarray, ref_grads)))
    got = dict(tree_items(pt_grads))
    assert want.keys() == got.keys()
    for path, ref in want.items():
        diff = np.abs(got[path].numpy() - ref).max()
        assert diff <= 1e-4 * np.abs(ref).max() + 1e-7, (path, diff)


# ------------------------------------------------------- scan_attention ----

ATTN_CASES = {
    # name: (B, S, Hq, Hkv, D, window, q_chunk, kv_chunk)
    "gqa-causal": (2, 16, 4, 2, 8, None, 2048, 512),
    "window-chunked": (2, 20, 4, 4, 8, 5, 8, 4),
    "window-gqa-ragged": (2, 19, 6, 2, 8, 7, 8, 4),
}


def _attn_inputs(case, seed=0):
    b, s, hq, hkv, d, *_ = ATTN_CASES[case]
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, hq, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32),
            np.broadcast_to(np.arange(s), (b, s)).astype(np.int32),
            r.standard_normal((b, s, hq, d)).astype(np.float32))


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_scan_attention_matches_reference(case):
    """Output in float32 and bfloat16, and the float32 gradients of
    ``sum(out * w)`` with respect to q, k and v."""
    *_, window, qc, kc = ATTN_CASES[case]
    q, k, v, pos, w = _attn_inputs(case)

    def attn(mod, *a):
        return mod.scan_attention(*a, window=window, q_chunk=qc,
                                  kv_chunk=kc)

    @jax.jit
    def ref(q_, k_, v_, qb, kb, vb):
        out, vjp = jax.vjp(lambda *a: attn(ref_L, *a, jnp.asarray(pos)),
                           q_, k_, v_)
        return out, vjp(jnp.asarray(w)), attn(ref_L, qb, kb, vb,
                                             jnp.asarray(pos))

    want, want_g, want_bf = ref(*(jnp.asarray(a) for a in (q, k, v)),
                                *(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tpos = torch.from_numpy(pos).long()
    got = attn(pt_L, *ts, tpos)
    assert got.dtype == torch.float32 and got.shape == q.shape
    f32 = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **f32)
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **f32)
    got_bf = attn(pt_L, *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                  tpos)
    assert got_bf.dtype == torch.bfloat16
    np.testing.assert_allclose(got_bf.float().numpy(),
                               np.asarray(want_bf, np.float32),
                               atol=5e-2, rtol=1e-2)


# -------------------------------------------------- mixers and MoE ---------


def _block(cfg, name):
    pt, ref = seeded_params(cfg, seed=3)
    return ({k: v[0] for k, v in pt["blocks"]["b0"][name].items()},
            jax.tree.map(lambda a: a[0], ref["blocks"]["b0"][name]))


def _against_vjp(ref_fn, pt_fn, x, seed):
    """``pt_fn(x)`` and its input gradient for a random cotangent against
    the jitted reference's output and ``vjp``, float32 atol/rtol 1e-4."""
    g = np.random.default_rng(seed).standard_normal(x.shape).astype(
        np.float32)

    @jax.jit
    def ref(a, ct):
        out, vjp = jax.vjp(ref_fn, a)
        return out, vjp(ct)[0]

    want, want_g = ref(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pt_fn(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), **F32)


def test_mamba_mix_matches_reference():
    """mamba_mix over S 20 in chunks of 8 (a state carried across chunks
    and a padded tail): output and input gradient."""
    cfg = one_period("jamba-v0.1-52b")
    assert cfg.pattern[0].mixer == "mamba"
    pt_p, ref_p = _block(cfg, "mamba")
    rcfg = ref_config(cfg)
    x = np.random.default_rng(4).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    _against_vjp(lambda a: ref_ssm.mamba_mix(ref_p, a, rcfg, chunk=8),
                 lambda a: pt_ssm.mamba_mix(pt_p, a, cfg, chunk=8), x, 5)


def test_rwkv_time_and_channel_mix_match_reference():
    """rwkv_mix (the reference in chunks of 8) followed by the channel-mix
    over S 20: output and input gradient."""
    cfg = one_period("rwkv6-3b")
    pt_t, ref_t = _block(cfg, "rwkv")
    pt_c, ref_c = _block(cfg, "rwkv_cm")
    rcfg = ref_config(cfg)
    x = np.random.default_rng(6).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)

    def ref_fn(a):
        return ref_ssm.rwkv_channel_mix(
            ref_c, ref_ssm.rwkv_mix(ref_t, a, rcfg, chunk=8), rcfg)

    _against_vjp(ref_fn, lambda a: pt_ssm.rwkv_channel_mix(
        pt_c, pt_ssm.rwkv_mix(pt_t, a, cfg)), x, 7)


def test_moe_at_training_length_drops_and_differentiates():
    """moe_ffn on (B 2, S 24) at capacity factor 0.5 (tokens dropped):
    output and the gradients of the input, the router and the expert
    stacks against ``jax.grad`` (the router's through the stable sort)."""
    cfg = one_period("granite-moe-3b-a800m", capacity_factor=0.5)
    pt_p, ref_p = _block(cfg, "moe")
    rcfg = ref_config(cfg)
    x = np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def ref(p, a):
        out, vjp = jax.vjp(lambda p_, a_: ref_L.moe_ffn(p_, a_, rcfg), p, a)
        return out, vjp(jnp.asarray(w))

    want, (g_p, g_x) = ref(ref_p, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in pt_p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pt_L.moe_ffn(live, xt, cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    (got * torch.from_numpy(w)).sum().backward()
    # the block's norm scale is the caller's: moe_ffn never reads it
    close_grads({"x": g_x, **g_p},
                {"x": xt.grad, **{k: torch.zeros_like(v) if v.grad is None
                                  else v.grad for k, v in live.items()}})
    assert np.abs(np.asarray(g_p["router"])).max() > 0
    cap = int(24 * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 1
    assert cap * cfg.num_experts < 24 * cfg.top_k     # some tokens dropped


# ------------------------------------------- forward, loss, gradients ------


def _batch(cfg, b=2, s=16, seed=0):
    return ref_synth_batch(ref_config(cfg),
                           RefDataConfig(global_batch=b, seq_len=s,
                                         seed=seed), step=0)


@pytest.fixture(scope="module", params=ARCHS)
def arch_case(request):
    """Per arch, once: the reference's hidden states, loss, metrics and
    gradients of ``loss_fn`` on one seeded synthetic batch (one jit)."""
    arch = request.param
    cfg = one_period(arch)
    rcfg = ref_config(cfg)
    pt_params, ref_params = seeded_params(cfg)
    batch = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, batch)

    def f(p):
        hidden = ref_M.forward(p, rcfg, tokens=jb.get("tokens"),
                               embeds=jb.get("embeds"))
        loss, m = ref_M.lm_loss(p, hidden, jb["targets"], rcfg)
        return loss, (hidden, m)

    (loss, (hidden, metrics)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(ref_params)
    return dict(arch=arch, cfg=cfg, params=pt_params, batch=batch,
                hidden=np.asarray(hidden), loss=float(loss),
                tokens=float(metrics["tokens"]), grads=grads)


def test_forward_matches_reference(arch_case):
    c = arch_case
    tb = to_device(c["batch"], CPU)
    with torch.no_grad():
        hidden = pt_M.forward(c["params"], c["cfg"], tokens=tb.get("tokens"),
                              embeds=tb.get("embeds"))
    assert hidden.shape == c["hidden"].shape
    np.testing.assert_allclose(hidden.numpy(), c["hidden"], **F32)


def test_loss_and_gradients_match_reference(arch_case):
    c = arch_case
    loss, metrics, grads = loss_and_grads(c["params"],
                                          to_device(c["batch"], CPU),
                                          c["cfg"])
    assert float(metrics["tokens"]) == c["tokens"]
    assert float(loss) == pytest.approx(c["loss"], rel=1e-5)
    assert float(metrics["loss"]) == float(loss)
    close_grads(c["grads"], grads)


def test_loss_masked_targets_softcap_and_padded_chunks():
    """olmo one period with ``logit_softcap`` 5, ``loss_chunk`` 6 over S
    16 (a padded tail chunk) and a third of the targets masked: loss,
    token count and gradients, with and without remat in the port."""
    cfg = one_period("olmo-1b", logit_softcap=5.0, loss_chunk=6)
    rcfg = ref_config(cfg)
    pt_params, ref_params = seeded_params(cfg, seed=8)
    batch = _batch(cfg, seed=9)
    batch["targets"][np.random.default_rng(10).random(
        batch["targets"].shape) < 1 / 3] = -1
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_M.loss_fn(p, b, rcfg), has_aux=True))(
        ref_params, jax.tree.map(jnp.asarray, batch))
    assert float(m["tokens"]) == float((batch["targets"] >= 0).sum())
    for remat in (True, False):
        got, gm, pt_grads = loss_and_grads(
            pt_params, to_device(batch, CPU),
            dataclasses.replace(cfg, remat=remat))
        assert float(gm["tokens"]) == float(m["tokens"])
        assert float(got) == pytest.approx(float(loss), rel=1e-5)
        close_grads(grads, pt_grads)


def test_forward_gradients_flow_into_stacked_leaves():
    """Two periods: each period's slice of a stacked leaf gets its own
    gradient, and checkpointing the periods (remat) changes no value."""
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"),
                              compute_dtype="float32")
    assert cfg.num_periods == 2
    params = pt_M.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = to_device(_batch(cfg), CPU)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = loss_and_grads(params, batch, c)
    assert float(out[True][0]) == float(out[False][0])
    for (path, a), (_, b) in zip(tree_items(out[True][2]),
                                 tree_items(out[False][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    wq = out[True][2]["blocks"]["b0"]["attn"]["wq"]
    assert wq.shape[0] == 2 and bool((wq[0] != 0).any()) and bool(
        (wq[1] != 0).any()) and not torch.equal(wq[0], wq[1])


# ------------------------------------------ decode reproduces forward ------


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-4b",
                                  "granite-moe-3b-a800m", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_decode_matches_forward(arch):
    """The port's ``decode_step`` walked token by token over the cache
    reproduces its ``forward`` logits (KV caches, ring buffers, SSM
    states), float32, on the whole smoke config."""
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    params = pt_M.init_params(torch.Generator().manual_seed(1), cfg,
                              device="cpu")
    b, t = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, t)))
    with torch.no_grad():
        hidden = pt_M.forward(params, cfg, tokens=tokens)
        want = (hidden @ pt_M.lm_head_weight(params, cfg)).float()
        cache = pt_M.init_cache(cfg, b, t, device="cpu")
        got = []
        for pos in range(t):
            logits, cache = pt_M.decode_step(params, cache, cfg,
                                             tokens[:, pos:pos + 1],
                                             torch.tensor(pos))
            got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               atol=2e-2, rtol=2e-2)

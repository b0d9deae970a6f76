"""The port's training substrate against the JAX package: the data
pipeline, AdamW, the masked and accumulating train step, checkpoints and
gradient compression; and the reference's training properties held on
the port's driver (the reference's own tests of them fail inside its
mesh under this JAX, not in the maths).

Tolerances:
- ``synth_batch``: byte-equal for every arch.
- ``optimizer.update`` on the reference's own gradients: params, m and
  v within 1e-6 relative (params: also atol 1e-6·lr, relative to the
  step, since an element near zero cancels; m, v atol 1e-12), ``lr`` and
  ``grad_norm`` within 1e-6 relative.
  The decay-mask set equals the reference's on every arch's tree.
- ``build_train_step`` with masks and ``accum_steps`` 2: loss and
  ``grad_norm`` within 1e-5 relative; params within ``2e-2·lr + 1e-6``
  (Adam's first step moves an element whose gradient is below ``eps``
  by up to ``2·lr·|g|/eps`` if its sign differs between the packages);
  masked elements exactly 0.
- Checkpoints: cross-restored byte-equal, meta.json equal.
  ``compress_tree``: equal int8 values and scales within 1 ulp.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.data import pipeline as ref_pipeline
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.models import model as ref_M
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import pipeline as pt_pipeline
from repro_torch.device import NoCudaDevice
from repro_torch.launch import train as pt_train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as pt_M
from repro_torch.sparse.pruning import (global_l1_prune, sparsity_of,
                                        tree_items, tree_map)
from repro_torch.train import checkpoint as pt_ckpt
from repro_torch.train import compression as pt_comp
from repro_torch.train import optimizer as pt_opt
from test_torch_threads import one_torch_thread  # noqa: F401  (fixture)

CPU = torch.device("cpu")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _one_period(arch="olmo-1b"):
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, num_layers=len(cfg.pattern),
                               compute_dtype="float32")


def _ref_cfg(cfg):
    rc = ref_get_smoke(cfg.name.removesuffix("-smoke"))
    return dataclasses.replace(rc, num_layers=cfg.num_layers,
                               compute_dtype=cfg.compute_dtype)


def _params(cfg, seed=0):
    return pt_M.init_params(torch.Generator().manual_seed(seed), cfg,
                            device="cpu")


def _np(tree):
    return tree_map(lambda _, t: t.detach().numpy().copy(), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------- data -----


@pytest.mark.parametrize("arch", ARCHS)
def test_synth_batch_byte_equal(arch):
    """Every arch's batches (tokens, targets, patch and frame embeds) are
    byte-equal to the reference's, for two steps and two hosts."""
    dc = dict(global_batch=4, seq_len=24, seed=3)
    for step, host in ((0, 0), (5, 1)):
        want = ref_pipeline.synth_batch(ref_get_smoke(arch),
                                        ref_pipeline.DataConfig(**dc), step,
                                        host=host, num_hosts=2)
        got = pt_pipeline.synth_batch(get_smoke_config(arch),
                                      pt_pipeline.DataConfig(**dc), step,
                                      host=host, num_hosts=2)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (arch, k)


def test_prefetcher_orders_steps_as_the_reference():
    cfg = get_smoke_config("olmo-1b")
    dc = pt_pipeline.DataConfig(global_batch=2, seq_len=16)
    pf = pt_pipeline.Prefetcher(cfg, dc, start_step=7)
    got = [next(pf) for _ in range(3)]
    pf.close()
    assert [s for s, _ in got] == [7, 8, 9]
    want = ref_pipeline.synth_batch(ref_get_smoke("olmo-1b"),
                                    ref_pipeline.DataConfig(2, 16), 8)
    assert got[1][1]["tokens"].tobytes() == want["tokens"].tobytes()


# ----------------------------------------------------------- optimizer -----


@pytest.mark.parametrize("step", [0, 5, 10, 100])
def test_schedule_matches_reference(step):
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=1)):
        want = float(ref_opt.schedule(ref_opt.OptConfig(**kw),
                                      jnp.int32(step)))
        got = float(pt_opt.schedule(pt_opt.OptConfig(**kw),
                                    torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_decay_mask_equals_reference_on_every_arch():
    for arch in ARCHS:
        for full in (False, True):
            cfg = (get_config if full else get_smoke_config)(arch)
            rcfg = (ref_get_config if full else ref_get_smoke)(arch)
            ref_shapes = ref_M.param_shapes(rcfg)
            flat, _ = jax.tree_util.tree_flatten_with_path(
                ref_shapes, is_leaf=lambda x: isinstance(x, tuple))
            want = {jax.tree_util.keystr(p) for p, _ in flat
                    if ref_opt._decay_mask(p)}
            got = {pt_opt.keystr(p) for p, _ in tree_items(
                pt_M.param_shapes(cfg)) if pt_opt._decay_mask(p)}
            assert got == want, arch
    assert tuple(ARCHS) == tuple(REF_ARCHS)


@pytest.fixture(scope="module")
def olmo_grads():
    """olmo one period: params, a batch and the reference's gradients of
    ``loss_fn`` there (one jit)."""
    cfg = _one_period()
    params = _params(cfg)
    batch = pt_pipeline.synth_batch(cfg, pt_pipeline.DataConfig(4, 16), 0)
    rcfg = _ref_cfg(cfg)
    grads = jax.jit(jax.grad(lambda p, b: ref_M.loss_fn(p, b, rcfg)[0]))(
        _jnp(_np(params)), _jnp(batch))
    return cfg, params, batch, jax.tree.map(np.asarray, grads)


def test_update_matches_reference_on_its_grads(olmo_grads):
    """Three AdamW steps (warm-up, then cosine; clipping active on the
    scaled-up grads) on the reference's gradients: params, m, v, lr and
    grad_norm after each."""
    _, params, _, grads = olmo_grads
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1,
                clip_norm=0.5)
    rp, rs = _jnp(_np(params)), ref_opt.init(_jnp(_np(params)))
    pp = tree_map(lambda _, t: t.clone(), params)
    ps = pt_opt.init(pp)
    for i in range(3):
        g = jax.tree.map(lambda a: a * (1 + 3 * i), grads)
        rp, rs, rm = ref_opt.update(rp, _jnp(g), rs,
                                    ref_opt.OptConfig(**ocfg))
        pp, ps, pm = pt_opt.update(pp, tree_map(
            lambda _, a: torch.from_numpy(a), g), ps,
            pt_opt.OptConfig(**ocfg))
        for k in ("lr", "grad_norm"):
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-6)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        # a parameter is p - lr·upd: 1e-6 relative to the step's scale lr
        # as well as to the value (an element near zero cancels)
        for want, got, atol in ((rp, pp, 1e-6 * ocfg["lr"]),
                                (rs["m"], ps["m"], 1e-12),
                                (rs["v"], ps["v"], 1e-12)):
            for (path, a), (_, b) in zip(tree_items(
                    jax.tree.map(np.asarray, want)), tree_items(got)):
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                           atol=atol, err_msg=str(path))


def test_train_step_masked_accumulated_matches_reference(olmo_grads):
    """``build_train_step`` with global-L1 masks (0.5) and
    ``accum_steps`` 2 on a batch of 4, two steps in a row."""
    cfg, params, _, _ = olmo_grads
    lr = 1e-2
    ocfg = dict(lr=lr, warmup_steps=1, total_steps=10)
    pruned = global_l1_prune(params, 0.5)
    masks = tree_map(lambda _, t: t != 0, pruned)
    flat_masks = dict(tree_items(masks))
    rmasks = jax.tree.map(lambda m: jnp.asarray(m, jnp.float32),
                          _np(masks))
    ref_step = jax.jit(ref_build_train_step(
        _ref_cfg(cfg), ref_opt.OptConfig(**ocfg), prune_masks=rmasks,
        accum_steps=2))
    pt_step = build_train_step(cfg, pt_opt.OptConfig(**ocfg),
                               prune_masks=masks, accum_steps=2)
    rp = _jnp(_np(pruned))
    rs = ref_opt.init(rp)
    pp = tree_map(lambda _, t: t.clone(), pruned)
    ps = pt_opt.init(pp)
    for step in range(2):
        batch = pt_pipeline.synth_batch(cfg, pt_pipeline.DataConfig(4, 16),
                                        step)
        rp, rs, rm = ref_step(rp, rs, _jnp(batch))
        pp, ps, pm = pt_step(pp, ps, pt_train.to_device(batch, CPU))
        assert set(pm) == set(rm) == {"loss", "tokens", "grad_norm", "lr"}
        for k in ("loss", "grad_norm"):
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-5)
        assert float(pm["tokens"]) == float(rm["tokens"])
        for (path, a), (_, b) in zip(tree_items(
                jax.tree.map(np.asarray, rp)), tree_items(pp)):
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=2e-2 * lr + 1e-6,
                                       err_msg=str(path))
            assert not bool(b[~flat_masks[path]].any()), path


def test_eval_and_prefill_logits_steps_match_reference(olmo_grads):
    """``build_eval_step``'s metrics and ``build_prefill_logits_step``'s
    last-position float32 logits against the reference's (float32
    atol/rtol 1e-4; loss relative 1e-5)."""
    from repro.launch.steps import build_eval_step as ref_eval
    from repro.launch.steps import build_prefill_logits_step as ref_logits
    from repro_torch.launch.steps import (build_eval_step,
                                          build_prefill_logits_step)
    cfg, params, batch, _ = olmo_grads
    rcfg, rp, jb = _ref_cfg(cfg), _jnp(_np(params)), _jnp(batch)
    tb = pt_train.to_device(batch, CPU)
    want = ref_eval(rcfg)(rp, jb)
    got = build_eval_step(cfg)(params, tb)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=1e-5)
    assert float(got["tokens"]) == float(want["tokens"])
    logits = build_prefill_logits_step(cfg)(params, tb)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(ref_logits(rcfg)(rp, jb)),
                               atol=1e-4, rtol=1e-4)


def test_accumulation_equals_single_pass():
    """``accum_steps`` 2 and 4 against one pass over the same batch of 8
    (the reference's ``test_accum`` property)."""
    cfg = _one_period()
    batch = pt_train.to_device(pt_pipeline.synth_batch(
        cfg, pt_pipeline.DataConfig(8, 16), 0), CPU)
    ocfg = pt_opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for accum in (1, 2, 4):
        p = _params(cfg)
        out[accum] = build_train_step(cfg, ocfg, accum_steps=accum)(
            p, pt_opt.init(p), batch)
    for accum in (2, 4):
        assert float(out[accum][2]["loss"]) == pytest.approx(
            float(out[1][2]["loss"]), abs=1e-5)
        for (_, a), (_, b) in zip(tree_items(out[1][0]),
                                  tree_items(out[accum][0])):
            assert float((a - b).abs().max()) < 1e-5


# --------------------------------------------------------- checkpoints -----


def _state_tree(seed=0):
    cfg = _one_period()
    params = _params(cfg, seed)
    state = pt_opt.init(params)
    state["m"] = tree_map(lambda _, t: torch.randn(
        t.shape, generator=torch.Generator().manual_seed(seed)), state["m"])
    state["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": params, "opt": state}


def test_checkpoints_cross_restore_byte_equal(tmp_path):
    """A port checkpoint restores in the reference and a reference one in
    the port, byte-equal; their files and meta.json are the same."""
    tree = _state_tree()
    pt_ckpt.save(str(tmp_path / "pt"), 3, tree)
    ref_tree = _jnp(_np(tree))
    ref_ckpt.save(str(tmp_path / "ref"), 3, ref_tree)
    a, b = tmp_path / "pt" / "step_3", tmp_path / "ref" / "step_3"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert (json.loads((a / "meta.json").read_text())
            == json.loads((b / "meta.json").read_text()))
    for name in os.listdir(a):
        if name.endswith(".npy"):
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    into_ref = ref_ckpt.restore(str(tmp_path / "pt"), 3, ref_tree)
    into_pt = pt_ckpt.restore(str(tmp_path / "ref"), 3, tree, device="cpu")
    for (path, want), (_, x), (_, y) in zip(
            tree_items(_np(tree)),
            tree_items(jax.tree.map(np.asarray, into_ref)),
            tree_items(into_pt)):
        assert x.dtype == y.numpy().dtype == want.dtype, path
        assert x.shape == tuple(y.shape) == want.shape, path
        assert x.tobytes() == want.tobytes() == y.numpy().tobytes(), path


def test_checkpoint_commit_gc_and_async(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    for s in (1, 2, 3, 4):
        t = pt_ckpt.save(d, s, tree_map(lambda _, x: x * s, tree), keep=2,
                         async_=(s % 2 == 0))
        if t is not None:
            t.join(timeout=30)
            assert not t.is_alive()
    assert sorted(pt_ckpt.completed_steps(d)) == [3, 4]
    os.makedirs(os.path.join(d, "step_9"))            # never committed
    os.makedirs(os.path.join(d, "step_8.tmp"))
    assert pt_ckpt.latest_step(d) == 4
    back = pt_ckpt.restore(d, 4, tree)
    assert torch.equal(back["a"], tree["a"] * 4)
    assert back["b"]["c"].dtype == torch.int32
    with pytest.raises(FileNotFoundError):
        pt_ckpt.restore(d, 9, tree)
    with pytest.raises(ValueError):
        pt_ckpt.restore(d, 4, {"a": torch.zeros(3), "b": tree["b"]})


def test_async_save_keeps_the_values_at_save_time(tmp_path, monkeypatch):
    """An async save of CPU tensors writes what they held when ``save``
    was called, though the next step updates them in place while the
    writer runs (the driver saves this way every ``ckpt_every`` steps)."""
    tree = _state_tree()
    want = _np(tree)
    started, release = pt_ckpt.threading.Event(), pt_ckpt.threading.Event()
    real_save = np.save

    def held_save(*args, **kw):           # the writer waits for the update
        started.set()
        release.wait(timeout=30)
        return real_save(*args, **kw)

    monkeypatch.setattr(pt_ckpt.np, "save", held_save)
    t = pt_ckpt.save(str(tmp_path), 1, tree, async_=True)
    assert started.wait(timeout=30)
    with torch.no_grad():                 # the next step, in place
        for _, leaf in tree_items(tree):
            leaf.add_(1)
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    back = pt_ckpt.restore(str(tmp_path), 1, tree, device="cpu")
    for (path, a), (_, b) in zip(tree_items(want), tree_items(back)):
        assert a.tobytes() == b.numpy().tobytes(), path


# --------------------------------------------------------- compression -----


def test_compress_tree_matches_reference():
    r = np.random.default_rng(0)
    grads = {"w": r.standard_normal((8, 16)).astype(np.float32) * 3,
             "b": {"x": r.standard_normal((5,)).astype(np.float32),
                   "z": np.zeros((3,), np.float32)}}
    rq, rs, rr = ref_comp.compress_tree(_jnp(grads))
    pq, ps, pr = pt_comp.compress_tree(tree_map(
        lambda _, a: torch.from_numpy(a), grads))
    for (path, a), (_, b) in zip(tree_items(jax.tree.map(np.asarray, rq)),
                                 tree_items(pq)):
        assert b.dtype == torch.int8 and np.array_equal(b.numpy(), a), path
    for want, got in ((rs, ps), (rr, pr)):
        for (_, a), (_, b) in zip(tree_items(jax.tree.map(np.asarray, want)),
                                  tree_items(got)):
            np.testing.assert_allclose(b.numpy(), a, rtol=1.2e-7, atol=0)
    deq = pt_comp.decompress_tree(pq, ps)
    np.testing.assert_allclose(deq["w"].numpy() + pr["w"].numpy(),
                               grads["w"], rtol=1e-6)
    fb = pt_comp.init_error_fb(pq, 4)
    assert fb["w"].shape == (4, 8, 16) and fb["w"].dtype == torch.float32
    # a world of one rank: the compressed all-reduce returns g + err
    # quantised and dequantised, and its residual with a leading dim of 1
    # (the n-rank arithmetic: tests/test_torch_spmd_train.py)
    from repro_torch.launch.mesh import Mesh
    g = tree_map(lambda _, a: torch.from_numpy(a), grads)
    fn = pt_comp.compressed_psum_grads(lambda p, b: g, Mesh())
    err = pt_comp.init_error_fb(g, 1)
    got, resid = fn(None, torch.zeros(1), err)
    for (path, a), (_, b), (_, r) in zip(tree_items(deq), tree_items(got),
                                         tree_items(resid)):
        assert torch.equal(a, b), path
        assert r.shape == (1, *a.shape)
    np.testing.assert_array_equal(resid["w"][0].numpy(), pr["w"].numpy())


# ------------------------------------------------------------- driver ------


def test_training_reduces_loss():
    """30 smoke olmo steps at lr 3e-3 on the synthetic stream drop the
    loss by at least 0.3 (the reference's ``test_training_reduces_loss``)."""
    res = pt_train.train("olmo-1b", smoke=True, steps=30, batch=8, seq=64,
                         lr=3e-3, device="cpu")
    first, last = np.mean(res["losses"][:3]), np.mean(res["losses"][-3:])
    assert last < first - 0.3, (first, last)
    assert np.isfinite(res["final_loss"]) and len(res["losses"]) == 30


class _Crash(Exception):
    pass


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path,
                                                     monkeypatch):
    """A 6-step run with checkpoints every 3 steps, crashed while it
    fetches step 4's batch and then resumed, gives bit-equal float32
    params and optimizer state to 6 uninterrupted steps; the resumed run
    takes only the remaining steps."""
    kw = dict(smoke=True, steps=6, batch=4, seq=32, device="cpu")
    whole = pt_train.train("olmo-1b", **kw)
    real = pt_train.Prefetcher

    class CrashAfter3(real):
        def __next__(self):
            step, batch = super().__next__()
            if step == 3:
                raise _Crash
            return step, batch

    d = str(tmp_path / "ck")
    monkeypatch.setattr(pt_train, "Prefetcher", CrashAfter3)
    with pytest.raises(_Crash):
        pt_train.train("olmo-1b", ckpt_dir=d, ckpt_every=3, **kw)
    assert pt_ckpt.latest_step(d) == 3
    monkeypatch.setattr(pt_train, "Prefetcher", real)
    res = pt_train.train("olmo-1b", ckpt_dir=d, ckpt_every=3, **kw)
    assert len(res["losses"]) == 3 and pt_ckpt.latest_step(d) == 6
    assert res["losses"] == whole["losses"][3:]
    for (path, a), (_, b) in zip(tree_items(whole["params"]),
                                 tree_items(res["params"])):
        assert a.dtype == torch.float32 and torch.equal(a, b), path
    state = pt_ckpt.restore(d, 6, {"params": whole["params"],
                                   "opt": pt_opt.init(whole["params"])})
    for (path, a), (_, b) in zip(tree_items(whole["params"]),
                                 tree_items(state["params"])):
        assert torch.equal(a, b), path


def test_sparse_training_keeps_masks():
    """granite smoke at sparsity 0.5 keeps ``sparsity_of`` > 0.4 after 10
    steps (the reference's sparse-training driver test)."""
    res = pt_train.train("granite-moe-3b-a800m", smoke=True, steps=10,
                         batch=4, seq=32, sparsity=0.5, lr=1e-3,
                         device="cpu")
    assert np.isfinite(res["final_loss"])
    assert sparsity_of(res["params"]) > 0.4


def test_cli_runs_on_cpu_and_defaults_to_cuda(capsys, monkeypatch):
    pt_train.main(["--arch", "rwkv6-3b", "--smoke", "--steps", "3",
                   "--batch", "2", "--seq", "16", "--sparsity", "0.5",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "pruned to" in out and "step     2 loss" in out
    assert "final loss:" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        pt_train.main(["--arch", "olmo-1b", "--smoke", "--steps", "1"])
    # a world of one rank clamps model_parallel to 1, as the reference's
    # make_elastic_mesh does on one device: the same steps as mp 1
    kw = dict(steps=2, batch=2, seq=16, device="cpu")
    two = pt_train.train("olmo-1b", model_parallel=2, **kw)
    assert two["mesh"].size == 1
    assert two["losses"] == pt_train.train("olmo-1b", **kw)["losses"]

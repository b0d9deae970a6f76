"""Port's sharded training over ``torch.distributed``: one gloo world of 4
CPU ranks per module (``tests/_torch_spmd_train_worker.py``) runs every
scenario; the port's one-rank step and the JAX package's unsharded step
run the same inputs here meanwhile.

(a) One train step at (data 2, model 2) for olmo-1b, moonshot (8
experts: expert parallelism) and jamba smoke, the reference
``test_spmd_matches_single_device``'s archs (jamba cut to two blocks of
every kind), on a batch of 8 x 16 whose
data halves hold different numbers of live targets.  (b) (data 4, model
1) on olmo with global-L1 masks and ``accum_steps`` 2.  (b') Baseline
mode (``REPRO_PERF_MODE=baseline`` for the reference, ``baseline=True``
for the port's specs and steps): olmo at (data 4, model 1), the moments
laid out like the params (no ZeRO-1); moonshot at (data 2, model 2),
tensor-parallel experts and the global MoE dispatch, whose capacity
ranks the whole batch's tokens, so every data rank takes the whole
batch and no gradient is all-reduced.  Each against the
port's one-rank ``build_train_step``: loss within 1e-5 relative, params
within 1e-4 (a tenth of the learning rate: AdamW's first step moves each
element by lr·g/(|g| + eps), so a gradient element near eps carries its
summation-order rounding into up to lr of the step; measured 3e-6 to
4e-5 here), and against the reference's unsharded step within its sharded
test's bounds (loss 1e-3, params 5e-3).  (c) ``compressed_psum_grads``
over 4 data ranks against the reference's on 4 fake CPU devices.  (d)
``launch.train.train`` at model_parallel 2 (mesh (2, 2)) for 4 steps,
and again with its last checkpoint dropped and resumed: bit-equal.  (e) The CLI
under ``torch.distributed.run``, started beside the world.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_spmd_train_worker as worker  # noqa: E402
from repro.launch.steps import build_train_step as ref_step  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.sparse.pruning import tree_items, tree_map  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from test_torch_forward import ref_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 240
CASES = [dict(name="olmo-dp2-tp2", arch="olmo-1b", mp=2, prune=False,
              accum=1),
         dict(name="moonshot-dp2-tp2", arch="moonshot-v1-16b-a3b", mp=2,
              prune=False, accum=1),
         dict(name="jamba-dp2-tp2", arch="jamba-v0.1-52b", mp=2,
              prune=False, accum=1),
         dict(name="olmo-dp4-masked-accum2", arch="olmo-1b", mp=1,
              prune=True, accum=2),
         dict(name="olmo-dp4-baseline", arch="olmo-1b", mp=1, prune=False,
              accum=1, baseline=True),
         dict(name="moonshot-dp2-tp2-baseline", arch="moonshot-v1-16b-a3b",
              mp=2, prune=False, accum=1, baseline=True)]
LOSS_REL, PARAM_ATOL = 1e-5, 1e-4           # against the one-rank port
REF_LOSS, REF_PARAM = 1e-3, 5e-3            # against the reference


@contextlib.contextmanager
def _perf_mode(case):
    """``REPRO_PERF_MODE=baseline`` while the reference traces a
    ``baseline`` case's step (it reads the variable at trace time)."""
    old = os.environ.pop("REPRO_PERF_MODE", None)
    if case.get("baseline"):
        os.environ["REPRO_PERF_MODE"] = "baseline"
    try:
        yield
    finally:
        os.environ.pop("REPRO_PERF_MODE", None)
        if old is not None:
            os.environ["REPRO_PERF_MODE"] = old


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _params_np(arch):
    cfg = worker.smoke_config(arch)
    return tree_map(lambda _, t: t.numpy(), init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))


def _one_rank(case, params_np):
    """The port's one-rank step on the case's inputs."""
    cfg, params, masks, batch = worker.step_inputs(case["arch"], params_np,
                                                   case["prune"])
    step = build_train_step(cfg, opt_lib.OptConfig(**worker.OPT),
                            prune_masks=masks, accum_steps=case["accum"],
                            baseline=case.get("baseline", False))
    p, _, m = step(params, opt_lib.init(params), batch)
    return ({k: float(v) for k, v in m.items()},
            {"/".join(path): t.numpy() for path, t in tree_items(p)})


def _reference(case, params_np):
    """The JAX package's unsharded step, jitted on one CPU device."""
    cfg, params, masks, batch = worker.step_inputs(case["arch"], params_np,
                                                   case["prune"])
    rcfg = ref_config(cfg)
    rmasks = (jax.tree.map(lambda m: jnp.asarray(m.numpy(), jnp.float32),
                           masks) if masks is not None else None)
    step = jax.jit(ref_step(rcfg, ref_opt.OptConfig(**worker.OPT),
                            prune_masks=rmasks, accum_steps=case["accum"]))
    rp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    with _perf_mode(case):
        p, _, m = step(rp, ref_opt.init(rp),
                       {k: jnp.asarray(v.numpy(), jnp.int32)
                        for k, v in batch.items()})
    return ({k: float(v) for k, v in m.items()},
            {"/".join(k.key for k in path): np.asarray(t) for path, t in
             jax.tree_util.tree_flatten_with_path(p)[0]})


_REF_COMPRESSION = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import numpy as np, jax, jax.numpy as jnp
    from repro.train.compression import (compressed_psum_grads,
                                         init_error_fb)
    mesh = jax.make_mesh((4,), ("data",))
    def grad_fn(params, batch):
        return {"w": jnp.mean(batch, axis=0) * params["w"]}
    fn = compressed_psum_grads(grad_fn, mesh, "data")
    params = {"w": jnp.ones((32,))}
    r = np.random.default_rng(0)
    batch = jnp.asarray(r.standard_normal((64, 32)), jnp.float32)
    err = init_error_fb({"w": jnp.zeros((32,))}, 4)
    grads, resid = fn(params, batch, err)
    grads2, resid2 = fn(params, batch, resid)
    exact = np.asarray(batch.reshape(4, 16, 32).mean(1).mean(0))
    print(json.dumps({"grads": np.asarray(grads["w"]).tolist(),
                      "resid": np.asarray(resid["w"]).tolist(),
                      "grads2": np.asarray(grads2["w"]).tolist(),
                      "resid2": np.asarray(resid2["w"]).tolist(),
                      "exact": exact.tolist()}))
""")


@pytest.fixture(scope="module")
def runs():
    """Start the world and the reference's compressed all-reduce, run the
    one-rank and reference steps here while they work, then gather every
    result."""
    archs = sorted({c["arch"] for c in CASES})
    params = {a: _params_np(a) for a in archs}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for a in archs:
            paths[a] = os.path.join(tmp, f"{a}.npz")
            np.savez(paths[a], **{"/".join(p): t
                                  for p, t in tree_items(params[a])})
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"params": paths, "cases": CASES}, f)
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": str(WORLD), "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_spmd_train_worker.py"),
             spec, tmp], env={**env, "RANK": str(r)}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REF_COMPRESSION],
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
        procs.append(_start_cli())
        try:
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                single = {c["name"]: _one_rank(c, params[c["arch"]])
                          for c in CASES}
            finally:
                torch.set_num_threads(n)
            ref = {c["name"]: _reference(c, params[c["arch"]])
                   for c in CASES}
            outs = [p.communicate(timeout=TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
        cli_proc, cli_out = procs.pop(), outs.pop()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"process {r} failed:\n{err[-3000:]}"
        ranks, arrays = [], []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                arrays.append({k: z[k] for k in z.files})
        d = ranks[0]["train"]
        restored = _restore_trained(d["ckpt_dir"], d["resumed_latest"])
    return {"ranks": ranks, "arrays": arrays, "single": single, "ref": ref,
            "ref_comp": json.loads(outs[-1][0].strip().splitlines()[-1]),
            "restored": restored,
            "cli": (cli_proc.returncode, *cli_out)}


def _start_cli():
    """The training CLI on 2 CPU ranks under ``torch.distributed.run``."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--arch", "olmo-1b", "--smoke",
         "--steps", "2", "--model-parallel", "2", "--dist-backend", "gloo",
         "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _restore_trained(d, step):
    """The world's last checkpoint restored in this one-rank process."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("olmo-1b")
    like = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = ckpt.restore(d, step, {"params": like,
                                   "opt": opt_lib.init(like)})
    return {"/".join(p): t.numpy() for p, t in tree_items(state["params"])}


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_sharded_step_matches_one_rank_and_reference(runs, case):
    name = case["name"]
    one_m, one_p = runs["single"][name]
    ref_m, ref_p = runs["ref"][name]
    assert abs(one_m["loss"] - ref_m["loss"]) < REF_LOSS
    # the data ranks split the batch unless the global MoE dispatch ranks
    # all of its tokens (baseline mode on an arch with experts)
    moe_global = bool(case.get("baseline")
                      and worker.smoke_config(case["arch"]).num_experts)
    split = WORLD // case["mp"] > 1 and not moe_global
    if moe_global:
        # the global dispatch drops other tokens than the per-row one
        default = runs["single"][name.replace("-baseline", "")][0]
        assert abs(one_m["loss"] - default["loss"]) > 1e-4, (one_m, default)
    for rank, res in enumerate(runs["ranks"]):
        r = res["steps"][name]
        ctx = f"{name} rank {rank}"
        assert r["mesh"] == {"data": WORLD // case["mp"],
                             "model": case["mp"]}, ctx
        # the metrics are the world's, equal on every rank
        assert r == runs["ranks"][0]["steps"][name], ctx
        assert r["loss"] == pytest.approx(one_m["loss"], rel=LOSS_REL), ctx
        assert r["tokens"] == one_m["tokens"] == ref_m["tokens"], ctx
        assert r["grad_norm"] == pytest.approx(one_m["grad_norm"],
                                               rel=LOSS_REL), ctx
        assert r["lr"] == one_m["lr"], ctx
        assert abs(r["loss"] - ref_m["loss"]) < REF_LOSS, ctx
        got = runs["arrays"][rank]
        for path, want in one_p.items():
            p = got[f"{name}/{path}"]
            np.testing.assert_allclose(p, want, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{ctx} {path}")
            np.testing.assert_allclose(p, ref_p[path], rtol=0,
                                       atol=REF_PARAM,
                                       err_msg=f"{ctx} {path}")
        assert r["gathers"] == 1, ctx
        assert r["all_reduces"] == (1 if split else 0), ctx
        if case.get("baseline"):
            # baseline mode: the moments are laid out like the params
            # (no ZeRO-1), so each rank updates its whole part
            assert r["moment_data_elems"] == 0, ctx
            assert r["moment_elems"] == r["param_part_elems"], ctx
            assert (r["moment_elems"] == r["moment_whole_elems"]) == \
                (case["mp"] == 1), ctx


def test_model_axis_halves_params_and_data_axis_splits_moments(runs):
    for rank, res in enumerate(runs["ranks"]):
        tp = res["steps"]["olmo-dp2-tp2"]
        # every block matrix shards over model (the embedding and the
        # norms are replicated, as the reference's rules leave them)
        assert tp["param_resident"] == (tp["param_whole"]
                                        - tp["param_model_sharded"] // 2)
        assert tp["param_model_sharded"] > 0.8 * tp["param_whole"], rank
        dp = res["steps"]["olmo-dp4-masked-accum2"]
        assert dp["param_resident"] == dp["param_whole"], rank
        assert dp["pruned_zero"], rank
        # ZeRO-1: every moment that a dim of which 4 divides is a quarter
        left = dp["moment_whole_elems"] - dp["moment_data_elems"] * 4
        assert dp["moment_elems"] == dp["moment_data_elems"] + left, rank
        assert dp["moment_data_elems"] * 4 > 0.95 * dp["moment_whole_elems"]


def _quantum(resid):
    """One quantum of the compressed all-reduce's output: the mean over
    the 4 ranks of their scales (max|g + err| / 127), divided by 4.  Each
    rank's gradient is its 16 rows' mean (the params are ones)."""
    batch = np.random.default_rng(0).standard_normal((64, 32)).astype(
        np.float32)
    g = batch.reshape(4, 16, 32).mean(1) + resid
    return float((np.abs(g).max(1) / 127).mean() / 4)


def test_compressed_psum_matches_reference(runs):
    ref = runs["ref_comp"]
    exact = np.asarray(ref["exact"])
    resid_ref = np.asarray(ref["resid"])
    q1, q2 = _quantum(0), _quantum(resid_ref)
    for rank, res in enumerate(runs["ranks"]):
        c = res["compression"]
        assert c["mesh"] == {"data": 4, "model": 1}, rank
        got = np.asarray(c["grads"])
        np.testing.assert_allclose(got, ref["grads"], rtol=0, atol=q1,
                                   err_msg=str(rank))
        np.testing.assert_allclose(np.asarray(c["resid"])[0],
                                   resid_ref[rank], rtol=0, atol=1e-6)
        # a second step carries each rank's residual (error feedback)
        np.testing.assert_allclose(c["grads2"], ref["grads2"], rtol=0,
                                   atol=q2)
        np.testing.assert_allclose(np.asarray(c["resid2"])[0],
                                   np.asarray(ref["resid2"])[rank], rtol=0,
                                   atol=1e-6)
        # against the exact mean: as close as the reference's own result
        # (its test's bound, 0.05, is for 8 shards; at 4 shards on the
        # same data the reference's own error is 0.0505)
        err = np.abs(got - exact).max()
        ref_err = np.abs(np.asarray(ref["grads"]) - exact).max()
        assert err <= ref_err + q1, (rank, err, ref_err)
        assert ref_err < 0.06 * max(np.abs(exact).max(), 1.0), ref_err
        assert c["grads"] == runs["ranks"][0]["compression"]["grads"]


def test_train_resumes_bit_equal_and_checkpoint_restores_whole(runs):
    d0 = runs["ranks"][0]["train"]
    assert d0["mesh"] == {"data": 2, "model": 2}
    assert d0["latest"] == 4 and d0["resumed_latest"] == 4
    assert len(d0["losses"]) == 4 and len(d0["resumed_losses"]) == 2
    assert all(np.isfinite(d0["losses"]))
    for rank, res in enumerate(runs["ranks"]):
        d = res["train"]
        assert d["losses"] == d0["losses"], rank
        assert d["resumed_losses"] == d0["losses"][2:], rank
        arr = runs["arrays"][rank]
        for key in [k for k in arr if k.startswith("trained/")]:
            path = key.removeprefix("trained/")
            assert np.array_equal(arr[key], arr["resumed/" + path]), \
                (rank, path)
            assert np.array_equal(arr[key], runs["arrays"][0][key])
            assert np.array_equal(arr[key], runs["restored"][path]), path


def test_cli_trains_sharded_under_torchrun(runs):
    rc, stdout, stderr = runs["cli"]
    assert rc == 0, stderr[-3000:]
    # rank 0 alone prints
    assert stdout.count("sharded: mesh {'data': 1, 'model': 2} over "
                        "gloo") == 1, stdout
    lines = [l for l in stdout.splitlines()
             if l.startswith("final loss: ")]
    assert len(lines) == 1 and np.isfinite(float(lines[0].split()[-1]))

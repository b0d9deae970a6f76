"""The port's lock-step ``serve()`` and its four examples
(``examples/torch/``) on the CPU.

``serve()``: the port's engine on the reference's weights (bridged),
driven by ``launch.serve.lock_step`` (what ``serve()`` runs after it
builds the engine), against the reference engine driven as the
reference's ``serve()`` drives it, outside its mesh (this JAX stops on
the ``with eng.mesh`` the reference enters), in float32: the same
(batch, steps) tokens, for olmo-1b and for musicgen's frames frontend.
The examples: each reaches ``OK`` on the CPU through its own
assertions; accelerator_study's design point (reg 8, 16x16) prints the
reference model's numbers; train_sparse_lm's two configs are the
reference example's.  Without a card the device examples raise.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import init_params as ref_init_params
from repro.serve import ServeEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as pt_smoke
from repro_torch.device import NoCudaDevice
from repro_torch.launch.serve import lock_step, serve
from repro_torch.serve import ServeEngine as PtEngine
from test_torch_threads import one_torch_thread  # noqa: F401  (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_serve(eng, steps, seed):
    """The reference ``launch.serve.serve``'s run on a built engine,
    without its ``with eng.mesh``."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, eng.cfg.vocab_size, (eng.num_slots, 1))
    reqs = [eng.submit([int(first[b, 0])], max_new_tokens=steps)
            for b in range(eng.num_slots)]
    eng.run()
    return np.stack([np.asarray(r.tokens, np.int32) for r in reqs])


@pytest.mark.parametrize("arch", ["olmo-1b", "musicgen-medium"])
def test_lock_step_serve_matches_reference_engine(arch, capsys):
    batch, steps, seed = 3, 6, 1
    cfg = dataclasses.replace(ref_smoke(arch), compute_dtype="float32")
    pcfg = dataclasses.replace(pt_smoke(arch), compute_dtype="float32")
    kw = dict(num_slots=batch, max_len=32, sparsity=0.5, seed=seed,
              head_sparsity=0.0)
    ref = _ref_serve(RefEngine(cfg, **kw), steps, seed)
    params = jax.tree.map(np.asarray,
                          ref_init_params(jax.random.PRNGKey(seed), cfg))
    eng = PtEngine(pcfg, params=params_from_numpy(params, device="cpu"),
                   device="cpu", **kw)
    out = lock_step(eng, steps, seed)
    assert out["tokens"].dtype == np.int32
    assert out["tokens"].shape == ref.shape == (batch, steps)
    np.testing.assert_array_equal(out["tokens"], ref)
    assert out["report"]["generated_tokens"] == batch * steps
    text = capsys.readouterr().out
    assert "serving at " in text and "weight sparsity" in text
    assert f"decoded {steps} steps x batch {batch} in " in text


def test_serve_builds_its_engine_and_defaults_to_the_card(monkeypatch):
    out = serve("musicgen-medium", smoke=True, batch=2, steps=3,
                max_len=16, device="cpu")
    assert out["tokens"].shape == (2, 3) and out["tok_per_s"] > 0
    assert out["report"]["weight_stream"]["packed_tensors"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        serve("olmo-1b", batch=1, steps=1)


def test_quickstart_on_the_cpu(capsys):
    _example("examples/torch/quickstart.py", "pt_quickstart").main(
        ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "speedup" in out or "utilization" in out, out
    assert "bitmap_spmm on cpu" in out and out.rstrip().endswith("OK")


def test_accelerator_study_design_point_equals_reference(monkeypatch,
                                                        capsys):
    """The port's sweep narrowed to the paper's design point (reg 8 on a
    16x16 array, in both sweeps; the whole sweep takes ~20 s here)
    prints the reference model's numbers."""
    from repro.core.accelerator import AcceleratorConfig, run_gemm
    from repro.core.bitmap import prune_global_l1, random_sparse
    from repro.core.energy import energy_from_stats, tops_per_watt
    study = _example("examples/torch/accelerator_study.py", "pt_study")
    monkeypatch.setattr(study, "REGS", (8,))
    monkeypatch.setattr(study, "ARRAYS", ((16, 16),))
    study.main([])
    out = capsys.readouterr().out.splitlines()
    rng = np.random.default_rng(0)
    x = random_sparse((256, 512), 0.45, rng)
    w = prune_global_l1(rng.standard_normal((256, 512)).astype(np.float32),
                        0.75)
    rep = run_gemm(x, w, AcceleratorConfig(reg_size=8))
    tw = tops_per_watt(rep.stats.macs, energy_from_stats(rep.stats).total_j)
    nums = (f"util={rep.utilization:.3f} mapm={rep.mapm:.3f} "
            f"tops/w={tw:.3f}")
    assert out == [
        "shared-register size sweep (PE array fixed 16x16):",
        f"  reg= 8 {nums} deadlock_breaks={rep.stats.deadlock_breaks}",
        "", "PE-array shape sweep (reg=8):", f"  16x16 {nums}", "OK"]


def test_serve_batched_on_the_cpu(one_torch_thread, capsys):
    _example("examples/torch/serve_batched.py", "pt_serve_batched").main(
        ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "across 6 requests on 2 slots" in out and "paged KV:" in out
    assert out.rstrip().endswith("OK")


def test_train_sparse_lm_configs_and_loss_drop(one_torch_thread, tmp_path,
                                               capsys):
    import repro_torch.configs as C
    import repro_torch.launch.train as T
    port = _example("examples/torch/train_sparse_lm.py", "pt_train_lm")
    ref = _example("examples/train_sparse_lm.py", "ref_train_lm")
    for preset in ("model_20m", "model_100m"):
        assert dataclasses.asdict(getattr(port, preset)()) == \
            dataclasses.asdict(getattr(ref, preset)()), preset
    hook = C.get_smoke_config
    port.main(["--steps", "6", "--batch", "2", "--seq", "16", "--device",
               "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "training olmo-100m (" in out and out.rstrip().endswith("OK")
    assert (tmp_path / "step_6").is_dir()
    # the smoke-config hook is put back
    assert C.get_smoke_config is hook and T.get_smoke_config is hook


def test_device_examples_need_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path in ("quickstart", "serve_batched", "train_sparse_lm"):
        mod = _example(f"examples/torch/{path}.py", f"pt_{path}_nocard")
        with pytest.raises(NoCudaDevice):
            mod.main(["--steps", "1"] if path == "train_sparse_lm" else [])

"""Whole runs on the CPU at small widths, past the look for a chip, with
the timed path sound and then broken underneath: ``correct`` must come
out true, then false, under each cell's own limits."""
import pytest
import torch

import run
from harness import manifest
from smallcfg import small_mix, small_model

SERVE_CELLS = ("olmo-1b.longgen", "granite-moe-3b-a800m.batch")


def _run(cell, seed=2**31 + 5, trace=False):
    bench = manifest.load()
    w = manifest.workload(bench, cell)
    return run.execute(cell, seed, 1.0, trace, torch.device("cpu"),
                       model=small_model(w["config"]),
                       mix=small_mix(manifest.traffic_file(w["traffic"])))


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_sound_serving_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_a_token_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    from repro_torch.serve import engine
    orig = engine.build_serve_step

    def broken(*a, **kw):
        step = orig(*a, **kw)

        def altered(*sa, **skw):
            nxt, logits, cache = step(*sa, **skw)
            return logits.argmin(-1), logits, cache
        return altered

    monkeypatch.setattr(engine, "build_serve_step", broken)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_sound_training_run_is_correct():
    out = _run("olmo-1b.train")
    assert out["correct"], out["checks"]


def _broken_train(monkeypatch, fault):
    from repro_torch.launch import steps
    from repro_torch.train import optimizer as opt_lib
    orig = steps.build_train_step

    def broken(cfg, opt_cfg, prune_masks=None, **kw):
        step = orig(cfg, opt_cfg, prune_masks=prune_masks, **kw)

        def faulty(params, opt_state, batch):
            if fault == "unchanged":
                _, metrics, grads = steps.loss_and_grads(params, batch, cfg)
                return params, opt_state, dict(
                    metrics, grad_norm=opt_lib.global_norm(grads))
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return step(params, opt_state, half)
        return faulty

    monkeypatch.setattr(steps, "build_train_step", broken)


@pytest.mark.parametrize("fault", ("unchanged", "half_batch"))
def test_a_broken_train_step_is_caught(fault, monkeypatch):
    _broken_train(monkeypatch, fault)
    out = _run("olmo-1b.train")
    assert not out["correct"], out["checks"]

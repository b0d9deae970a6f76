"""Training driver on one device.

Port of ``repro/launch/train.py`` without the mesh (one card; several
GPUs are ROADMAP queue 1 item 6):
  * seeded init on the device, optional global-L1 pruning with masks
    kept through training (masked-gradient sparse training);
  * step-atomic checkpoints every ``ckpt_every`` with async write-behind,
    auto-resume from the latest committed step;
  * deterministic step-indexed data from a background prefetcher;
  * per-step loss / grad-norm / lr / wall log line and a straggler
    watchdog that flags steps slower than ``straggler_factor``× the
    trailing median.

Run (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu
Without ``--device`` it runs on ``cuda`` and raises ``NoCudaDevice``
where there is no card.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import init_params
from repro_torch.sparse.pruning import (global_l1_prune, sparsity_of,
                                        tree_map)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptConfig


def to_device(batch_np: dict, device: torch.device) -> dict:
    """A ``synth_batch`` dict of numpy arrays as tensors on ``device``:
    token ids and targets int64, embeds as they are (float32)."""
    out = {}
    for k, a in batch_np.items():
        t = torch.from_numpy(a)
        out[k] = (t.long() if k in ("tokens", "targets") else t).to(device)
    return out


def train(arch: str, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, ckpt_dir: str | None = None, ckpt_every: int = 20,
          sparsity: float = 0.0, lr: float = 3e-4, model_parallel: int = 1,
          straggler_factor: float = 3.0, log_every: int = 1,
          seed: int = 0, device: torch.device | str | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps (counting any resumed ones);
    returns {"final_loss", "losses", "params"}."""
    if model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1 needs several devices: ROADMAP queue 1 "
            "item 6 (multiple GPUs)")
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt_cfg = OptConfig(lr=lr, total_steps=max(steps, 2),
                        warmup_steps=max(steps // 10, 1))

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, cfg, device=device)
    masks = None
    if sparsity > 0:
        params = global_l1_prune(params, sparsity)
        masks = tree_map(lambda _, p: p != 0, params)
        print(f"pruned to {sparsity_of(params):.2%} sparsity")
    opt_state = opt_lib.init(params)

    start_step = 0
    if ckpt_dir:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            print(f"resuming from checkpoint step {latest}")
            state = ckpt.restore(ckpt_dir, latest,
                                 {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest

    step_fn = build_train_step(cfg, opt_cfg, prune_masks=masks)
    data_cfg = DataConfig(global_batch=batch, seq_len=seq, seed=seed)
    loader = Prefetcher(cfg, data_cfg, start_step=start_step)
    times: list = []
    losses: list = []
    pending_ckpt = None
    try:
        for _ in range(steps - start_step):
            step_idx, batch_np = next(loader)
            t0 = time.time()
            params, opt_state, metrics = step_fn(
                params, opt_state, to_device(batch_np, device))
            loss = float(metrics["loss"])
            dt = time.time() - t0
            times.append(dt)
            losses.append(loss)
            if len(times) >= 5:
                med = statistics.median(times[-20:])
                if dt > straggler_factor * med:
                    print(f"[straggler] step {step_idx}: {dt:.2f}s vs "
                          f"median {med:.2f}s", flush=True)
            if step_idx % log_every == 0:
                print(f"step {step_idx:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms",
                      flush=True)
            if ckpt_dir and (step_idx + 1) % ckpt_every == 0:
                if pending_ckpt is not None:
                    pending_ckpt.join()
                pending_ckpt = ckpt.save(
                    ckpt_dir, step_idx + 1,
                    {"params": params, "opt": opt_state}, async_=True)
    finally:
        loader.close()
        if pending_ckpt is not None:
            pending_ckpt.join()
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": opt_state})
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, sparsity=args.sparsity,
                lr=args.lr, model_parallel=args.model_parallel,
                device=args.device)
    print(f"final loss: {res['final_loss']:.4f}")


if __name__ == "__main__":
    main()

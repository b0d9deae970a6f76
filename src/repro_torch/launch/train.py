"""The training loop and CLI, on one device or over a
``torch.distributed`` world.

Port of ``repro/launch/train.py``:
  * the elastic (data, model) mesh with ``model <= model_parallel``
    (``launch/mesh.py``): the params and masks stored by
    ``param_specs``, the Adam moments by ``opt_specs`` (ZeRO-1 over
    data), each rank's rows of the batch by ``batch_specs``
    (``launch/steps.build_train_step_spmd``); a world of one rank trains
    alone, ``model_parallel`` clamped to 1 as the reference clamps it;
  * seeded init on the device, optional global-L1 pruning with masks
    kept through training (masked-gradient sparse training), both on the
    whole tree before it is sharded (the threshold is global);
  * step-atomic checkpoints every ``ckpt_every`` with async write-behind,
    auto-resume from the latest committed step (sharded state is saved
    whole by rank 0, and restored at any mesh shape);
  * deterministic step-indexed data from a background prefetcher;
  * per-step loss / grad-norm / lr / wall log line and a straggler
    watchdog that flags steps slower than ``straggler_factor``× the
    trailing median.

Run (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu
Without ``--device`` it runs on ``cuda`` and raises ``NoCudaDevice``
where there is no card.  Sharded, one process per rank
(``torch.distributed.run`` sets RANK / WORLD_SIZE / LOCAL_RANK; only
rank 0 prints and writes):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch olmo-1b --smoke --steps 2 \\
      --model-parallel 2 --dist-backend gloo --device cpu
``--dist-backend nccl`` puts rank r on cuda:LOCAL_RANK; ``gloo`` lets
several ranks share the card ``--device`` names.
"""
from __future__ import annotations

import argparse
import os
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import BACKENDS, init_world, make_elastic_mesh
from repro_torch.launch.steps import build_train_step, build_train_step_spmd
from repro_torch.models.perf_flags import baseline_mode
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
    returns {"final_loss", "losses", "params", "mesh", "specs"}: in a
    sharded world ``params`` holds this rank's parts by ``specs``
    (``launch.sharding.param_specs``).  Every rank of a world calls this
    alike; only rank 0 prints and writes checkpoints."""
    device = resolve_device(device)
    # a world of one rank clamps model_parallel to 1, as the reference's
    # make_elastic_mesh clamps to the live devices
    mesh = make_elastic_mesh(model_parallel, device.type)
    sharded = mesh.size > 1
    rank0 = mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt_cfg = OptConfig(lr=lr, total_steps=max(steps, 2),
                        warmup_steps=max(steps // 10, 1))

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, cfg, device=device)
    masks = None
    if sparsity > 0:
        params = global_l1_prune(params, sparsity)
        masks = tree_map(lambda _, p: p != 0, params)
        say(f"pruned to {sparsity_of(params):.2%} sparsity")
    opt_state = opt_lib.init(params)
    baseline = baseline_mode()          # REPRO_PERF_MODE, read once
    pspecs = shd.param_specs(cfg, mesh, baseline=baseline)
    specs = {"params": pspecs,
             "opt": shd.opt_specs(cfg, mesh, baseline=baseline)}
    if sharded:
        params = shd.shard_tree(params, pspecs, mesh)
        opt_state = shd.shard_tree(opt_state, specs["opt"], mesh)
        if masks is not None:
            masks = shd.shard_tree(masks, pspecs, mesh)
        say(f"sharded: mesh {mesh.shape} over {mesh.backend}")
    place = dict(specs=specs, mesh=mesh) if sharded else {}

    start_step = 0
    if ckpt_dir:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            say(f"resuming from checkpoint step {latest}")
            state = ckpt.restore(ckpt_dir, latest,
                                 {"params": params, "opt": opt_state},
                                 **place)
            params, opt_state = state["params"], state["opt"]
            start_step = latest

    step_fn = (build_train_step_spmd(cfg, opt_cfg, mesh, prune_masks=masks,
                                     baseline=baseline)
               if sharded else
               build_train_step(cfg, opt_cfg, prune_masks=masks,
                                baseline=baseline))
    # every rank reads the whole step-indexed batch; the step takes its
    # rows
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
                    say(f"[straggler] step {step_idx}: {dt:.2f}s vs "
                        f"median {med:.2f}s", flush=True)
            if step_idx % log_every == 0:
                say(f"step {step_idx:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms",
                    flush=True)
            if ckpt_dir and (step_idx + 1) % ckpt_every == 0:
                if pending_ckpt is not None:
                    pending_ckpt.join()
                pending_ckpt = ckpt.save(
                    ckpt_dir, step_idx + 1,
                    {"params": params, "opt": opt_state}, async_=True,
                    **place)
    finally:
        loader.close()
        if pending_ckpt is not None:
            pending_ckpt.join()
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": opt_state},
                  **place)
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "params": params, "mesh": mesh,
            "specs": pspecs}


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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="shard the params over this many ranks of the "
                         "torch.distributed world (the model axis of the "
                         "largest mesh that divides it; the rest is data)")
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="collectives of a world of several ranks (started "
                         "by torch.distributed.run): nccl, one card per "
                         "rank, or gloo (through host memory; several "
                         "ranks may share a card or run on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = args.device
    if world > 1:
        if args.dist_backend is None:
            ap.error(f"a world of {world} ranks needs --dist-backend "
                     f"(nccl or gloo)")
        device = init_world(args.dist_backend, args.device or "cuda")
    try:
        res = train(args.arch, smoke=args.smoke, steps=args.steps,
                    batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, sparsity=args.sparsity,
                    lr=args.lr, model_parallel=args.model_parallel,
                    device=device)
        if res["mesh"].rank == 0:
            print(f"final loss: {res['final_loss']:.4f}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

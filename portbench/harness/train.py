"""The training driver: the port's masked sparse train step.

Set-up makes the weights from the seed, prunes them with the program's
``global_l1_prune`` and takes their non-zeros as the masks, builds
``build_train_step`` with AdamW and drives that one object through its
first steps (the reference follows them): each step's loss and global
gradient norm before clipping, each leaf's first clipped gradient (read
back from the optimizer's first moment, kept on the device) and each
leaf's change over those steps are kept.  The window goes on
with the same object and feed, a fresh batch each step.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from harness import profiling, traffic
from harness.serve import port_config
from harness.manifest import reference_module
from harness.weights import make_params


class Train:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model, self.mix = ctx.model, ctx.mix
        self.device = ctx.device
        self.steps: List[Dict] = []
        self.profile = None
        self.batch_index = 0

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch(self):
        tokens, targets = traffic.train_batch(
            self.mix, self.model["vocab_size"], self.ctx.seed,
            self.batch_index)
        self.batch_index += 1
        return {"tokens": torch.from_numpy(tokens).to(self.device),
                "targets": torch.from_numpy(targets).to(self.device)}

    def setup(self) -> None:
        from repro_torch.launch.steps import build_train_step
        from repro_torch.sparse.pruning import (global_l1_prune, tree_items,
                                                tree_map)
        from repro_torch.train import optimizer as opt_lib
        self.cfg = port_config(self.model)
        if self.cfg.remat != self.mix["remat"]:
            raise SystemExit(f"the port's remat is {self.cfg.remat}, the "
                             f"mix asks for {self.mix['remat']}")
        dense = make_params(self.model, self.ctx.seed, self.device)
        params = global_l1_prune(dense, self.model["sparsity"])
        del dense
        self.masks = tree_map(lambda _, p: p != 0, params)
        self.opt_cfg = opt_lib.OptConfig(**self.mix["opt"])
        self.opt = opt_lib.init(params)
        self.step_fn = build_train_step(self.cfg, self.opt_cfg,
                                        prune_masks=self.masks)
        self.params = params
        if self.ctx.trace:
            profiling.warm(self.device)
        start = {p: l.clone() for p, l in tree_items(params)}
        losses, norms = [], []
        first = {}
        for i in range(self.mix["check_steps"]):
            _, loss, m = self._run_step()
            losses.append(loss)
            norms.append(float(m["grad_norm"]))
            if i == 0:
                # the first clipped gradient, as the optimizer got it
                vec = {p: m / (1 - self.opt_cfg.beta1)
                       for p, m in tree_items(self.opt["m"])}
                first = {p: float(torch.linalg.vector_norm(v))
                         for p, v in vec.items()}
        change = {p: float(torch.linalg.vector_norm(l - start[p]))
                  for p, l in tree_items(self.params)}
        zeros = {p: int(l.numel() - torch.count_nonzero(l))
                 for p, l in tree_items(self.params)}
        del start
        self.readings = {"losses": losses, "grad_norms": norms,
                         "first_grad": first, "first_grad_vec": vec,
                         "change": change, "zeros": zeros}
        self._sync()

    def _run_step(self):
        batch = self._batch()
        self.params, self.opt, m = self.step_fn(self.params, self.opt,
                                                batch)
        loss = float(m["loss"])          # waits for the step
        if not math.isfinite(loss):
            raise RuntimeError(f"loss {loss} at batch {self.batch_index}")
        return batch, loss, m

    def window(self) -> Dict:
        b, s = self.mix["batch"], self.mix["seq_len"]
        t0 = time.perf_counter()
        te = t0
        while te - t0 < self.ctx.seconds:
            ts = time.perf_counter()
            self._run_step()
            te = time.perf_counter()
            self.steps.append({"t": ts, "dt": te - ts})
        self.attempted, self.failed = len(self.steps), 0
        return {"train_tok_s": len(self.steps) * b * s / (te - t0)}

    def trace(self) -> None:
        """Forward and backward alone, timed on the card's clock, then a
        few steps under the profiler."""
        from repro_torch.launch.steps import loss_and_grads
        batch = self._batch()
        self._sync()
        if torch.device(self.device).type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            loss_and_grads(self.params, batch, self.cfg)
            z.record()
            self._sync()
            self.fwd_bwd_s = a.elapsed_time(z) * 1e-3
        else:
            t = time.perf_counter()
            loss_and_grads(self.params, batch, self.cfg)
            self.fwd_bwd_s = time.perf_counter() - t
        gc.collect()
        with profiling.Profiled(self.device) as prof:
            for _ in range(self.mix["profile_steps"]):
                with torch.profiler.record_function("portbench.step"):
                    self._run_step()
        self.profile = prof

    def release(self) -> Dict:
        self.params = self.opt = self.masks = self.step_fn = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return self.readings

    def param_count(self) -> int:
        return sum(math.prod(s) for _, s in
                   reference_module(self.model).leaf_shapes(self.model))

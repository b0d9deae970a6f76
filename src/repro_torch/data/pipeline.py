"""Deterministic sharded synthetic-token pipeline with prefetch.

A copy of ``repro/data/pipeline.py`` (numpy only) with its imports
rewritten: the same (config, step, host) gives byte-equal batches in
both packages, musicgen's frame ``embeds`` included.

Design points that matter at cluster scale:

* **step-indexed determinism** — batch ``i`` is a pure function of
  (seed, step, host), so a restarted/elastic job resumes mid-stream with no
  data replay or skip bookkeeping (straggler/restart mitigation);
* **host sharding** — each host materialises only its slice of the global
  batch (``process_index``-strided rows);
* **prefetch** — a background thread keeps ``depth`` batches ready so host
  data generation overlaps device compute.

The generator is a marked-Zipf synthetic LM stream (repeatable structure so
loss actually drops during the examples' training runs).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    structure_period: int = 16   # injects learnable periodic structure


def _batch_rng(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def synth_batch(model_cfg: ModelConfig, cfg: DataConfig, step: int,
                host: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
    """Materialise this host's slice of global batch ``step``."""
    assert cfg.global_batch % num_hosts == 0
    b = cfg.global_batch // num_hosts
    s = cfg.seq_len
    rng = _batch_rng(cfg, step, host)
    v = model_cfg.vocab_size
    # zipf-distributed tokens; odd positions copy their predecessor, giving
    # the model learnable structure (loss verifiably drops in the examples)
    base = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64) % v
    odd = base[:, 1::2]
    base[:, 1::2] = base[:, 0::2][:, :odd.shape[1]]
    tokens = base.astype(np.int32)

    batch: Dict[str, np.ndarray] = {}
    if model_cfg.frontend == "frames":
        batch["embeds"] = rng.standard_normal(
            (b, s, model_cfg.d_model)).astype(np.float32)
        batch["targets"] = tokens
    elif model_cfg.frontend == "patches":
        fl = model_cfg.frontend_len
        batch["embeds"] = rng.standard_normal(
            (b, fl, model_cfg.d_model)).astype(np.float32)
        batch["tokens"] = tokens[:, :s - fl]
        tg = np.concatenate(
            [np.full((b, fl), -1, np.int32), tokens[:, :s - fl]], axis=1)
        batch["targets"] = tg
    else:
        batch["tokens"] = tokens
        # next-token targets with the final position masked
        tg = np.concatenate(
            [tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        batch["targets"] = tg
    return batch


class Prefetcher:
    """Background-thread prefetch of ``synth_batch`` outputs.

    In a sharded training world every rank's prefetcher yields the whole
    step-indexed batch (host 0 of 1), and the train step takes the rank's
    rows (``launch/steps.build_train_step_spmd``)."""

    def __init__(self, model_cfg: ModelConfig, cfg: DataConfig,
                 start_step: int = 0, depth: int = 2,
                 host: int = 0, num_hosts: int = 1):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = synth_batch(model_cfg, cfg, step, host, num_hosts)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.25)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()

"""Fault-tolerant checkpointing: atomic, resumable, the reference's layout.

Port of ``repro/train/checkpoint.py`` over nested dicts of tensors.

Layout:  <dir>/step_<n>/
            meta.json              — step, tree structure, leaf count
            leaf_<i>.npy           — one array per leaf, sorted-key order
            _COMPLETE              — commit marker (written last)

The leaves are numbered in the reference's flatten order (dict keys
sorted) and ``meta.json`` spells the tree as ``str(PyTreeDef)`` does, so
a checkpoint written by either package restores in the other.  Writes go
to ``step_<n>.tmp`` and are renamed only after the commit marker is in
place, so a crash mid-write never corrupts the latest checkpoint;
``latest_step`` ignores uncommitted directories.  Retries wrap the
filesystem ops.  An optional background thread gives async write-behind
(the host copy is taken before it starts).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.sparse.pruning import tree_items, tree_map


def _retry(fn: Callable, attempts: int = 3, delay: float = 0.5):
    for i in range(attempts):
        try:
            return fn()
        except OSError:
            if i == attempts - 1:
                raise
            time.sleep(delay * (2 ** i))


def treedef_str(tree: Any) -> str:
    """The tree's structure as ``str(jax.tree.flatten(tree)[1])`` spells
    a nested dict: sorted keys, ``*`` for each leaf."""
    def spell(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {spell(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({spell(tree)})"


def save(ckpt_dir: str, step: int, tree: Any,
         keep: int = 3, async_: bool = False) -> Optional[threading.Thread]:
    """Checkpoint a nested dict of tensors.  With ``async_`` the host
    copies are taken now and the files written on a daemon thread, which
    is returned (join it before the next save).  The copies are real ones
    on the CPU too, where ``.cpu()`` would share the leaf's memory and
    the next in-place update would reach the files being written."""
    host_leaves = [l.detach().to("cpu", copy=True).numpy()
                   for _, l in tree_items(tree)]
    structure = treedef_str(tree)

    def write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        _retry(lambda: os.makedirs(tmp, exist_ok=True))
        for i, arr in enumerate(host_leaves):
            _retry(lambda a=arr, j=i: np.save(
                os.path.join(tmp, f"leaf_{j}.npy"), a))
        meta = {"step": step, "num_leaves": len(host_leaves),
                "treedef": structure}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        _retry(lambda: os.rename(tmp, final))
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(completed_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def completed_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "_COMPLETE")):
                out.append(int(name.split("_")[1]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = completed_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any,
            device: torch.device | str | None = None) -> Any:
    """Restore into the structure of ``like`` (a nested dict of tensors):
    each leaf takes ``like``'s dtype and lands on ``device`` (``like``'s
    leaf's device unless named)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"checkpoint {path} is not committed")
    index = {p: i for i, (p, _) in enumerate(tree_items(like))}

    def load(p, ref):
        arr = _retry(lambda: np.load(os.path.join(path,
                                                  f"leaf_{index[p]}.npy")))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {index[p]}: {arr.shape} vs "
                             f"{tuple(ref.shape)}")
        return torch.from_numpy(arr).to(
            ref.device if device is None else device, ref.dtype)

    return tree_map(load, like)

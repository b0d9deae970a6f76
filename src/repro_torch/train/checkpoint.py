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

Sharded state (each rank's parts, ``launch.sharding.shard_tree``) is
saved whole: every rank gathers each leaf in turn, and rank 0 alone
writes, so the files are those of a one-rank save of the same state.
Restoring, every rank reads the whole leaves and keeps its parts, so a
run may resume at another mesh shape.
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


def _host_copy(leaf: torch.Tensor) -> np.ndarray:
    return leaf.detach().to("cpu", copy=True).numpy()


def save(ckpt_dir: str, step: int, tree: Any,
         keep: int = 3, async_: bool = False, specs: Any = None,
         mesh=None) -> Optional[threading.Thread]:
    """Checkpoint a nested dict of tensors.  With ``async_`` the host
    copies are taken now and the files written on a daemon thread, which
    is returned (join it before the next save).  The copies are real ones
    on the CPU too, where ``.cpu()`` would share the leaf's memory and
    the next in-place update would reach the files being written.

    ``specs`` / ``mesh``: ``tree`` holds this rank's parts of a sharded
    state (a spec tree shaped as ``tree``).  Every rank of the mesh must
    call this alike: each leaf is gathered whole (one leaf on the device
    at a time) and rank 0 takes the host copies and writes; the other
    ranks write nothing and return None."""
    if mesh is not None and mesh.size > 1:
        from repro_torch.launch.sharding import gather_leaf
        flat = dict(tree_items(specs))
        host_leaves = []
        for path, leaf in tree_items(tree):
            whole = gather_leaf(leaf, flat[path], mesh)
            if mesh.rank == 0:
                host_leaves.append(_host_copy(whole))
            del whole
        if mesh.rank != 0:
            return None
    else:
        host_leaves = [_host_copy(l) for _, l in tree_items(tree)]
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
            device: torch.device | str | None = None, specs: Any = None,
            mesh=None) -> Any:
    """Restore into the structure of ``like`` (a nested dict of tensors):
    each leaf takes ``like``'s dtype and lands on ``device`` (``like``'s
    leaf's device unless named).  ``specs`` / ``mesh``: ``like`` holds
    this rank's parts; each whole leaf is read and this rank's part of
    it kept (by the current mesh, whatever mesh wrote the files)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"checkpoint {path} is not committed")
    index = {p: i for i, (p, _) in enumerate(tree_items(like))}
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        from repro_torch.launch.sharding import shard_leaf, whole_shape
        flat = dict(tree_items(specs))

    def load(p, ref):
        arr = _retry(lambda: np.load(os.path.join(path,
                                                  f"leaf_{index[p]}.npy")))
        want = (whole_shape(ref, flat[p], mesh) if sharded
                else tuple(ref.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {index[p]}: {arr.shape} vs {want}")
        t = torch.from_numpy(arr)
        if sharded:
            t = shard_leaf(t, flat[p], mesh).contiguous()
        return t.to(ref.device if device is None else device, ref.dtype)

    return tree_map(load, like)

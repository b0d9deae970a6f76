"""Sharding rules over the (data, model) mesh: dense parameters, the
optimizer's moments, the batch, and the packed serving stack.

Port of ``repro/launch/sharding.py``.  The dense rules (``_RULES``,
``_MOE_RULES``, ``_MOE_RULES_EP``) are the reference's regexes over the
parameters' key paths (``sparse.pruning.keystr``), applied to
``models.model.param_shapes``.  A spec is a plain tuple with one axis
name (or ``None``) per dim, the reference's ``PartitionSpec`` as a
tuple; an axis that does not divide its dim falls back to replication
(``_fit``).  Where the reference places arrays with ``NamedSharding``,
each rank here keeps its contiguous block (``shard_leaf`` /
``shard_tree``) and the steps all-gather the blocks they need
(``gather_leaf`` / ``gather_tree``).  A sharded tree keeps each leaf's
whole shape beside its part: ``whole_shape`` of the part, its spec and
the mesh.

Packed serving stack: column-parallel tensors split the N tile axis
(each shard owns its output columns); row-parallel tensors split K
(per-shard partial products sum, as ``kernels/ops._sharded_spmm``
composes them).  The LM head is vocabulary-split (col).  Tensors with no
rule (router, SSM decay and mix tensors, norms) stay replicated; each
rank keeps the shard its place on the ``model`` axis names
(``keep_local``), and the serving steps gather them
(``launch/steps.build_serve_step_spmd``).

``REPRO_MOE_EP`` (``1``: expert parallelism, ``0``: tensor parallelism)
forces the MoE rules; baseline mode (``models/perf_flags.py``, the
``baseline`` argument, read from the environment only when it is None)
takes tensor parallelism and lays the Adam moments out like the params
(no ZeRO-1), as the reference's do.  ``cache_specs`` gives the decode
cache's specs (the dry run's, ``launch/dryrun.py``).  Not ported:
``named``: torch has no ``NamedSharding``.
"""
from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_structs, param_shapes
from repro_torch.models.perf_flags import baseline_mode
from repro_torch.sparse.format import (BitmapWeight, all_gather_concat,
                                       keep_part)
from repro_torch.sparse.pruning import keystr, tree_items, tree_map

Spec = Tuple[Any, ...]

# (regex over the key path, spec over the *unstacked* leaf dims)
_RULES = [
    (r"embed$", ("model", None)),
    (r"lm_head$", (None, "model")),
    (r"\['w[qkv]'\]$", (None, "model")),
    (r"\['wo'\]$", ("model", None)),
    (r"(w_gate|w_up|cm_k)'\]$", (None, "model")),
    (r"(w_down|cm_v)'\]$", ("model", None)),
    (r"router'\]$", (None, None)),
    (r"in_proj'\]$", (None, "model")),
    (r"(conv_w|x_proj|A_log|out_proj)'\]$", ("model", None)),
    (r"(conv_b|dt_bias)'\]$", ("model",)),
    (r"\['D'\]$", ("model",)),
    (r"dt_proj'\]$", (None, "model")),
    (r"w_[rkvg]'\]$", (None, "model")),
    (r"w_o'\]$", ("model", None)),
]

# tensor parallelism inside each expert: w_down shards its output dim, so
# the combine stays local
_MOE_RULES = [
    (r"moe'\]\['w_(gate|up)'\]$", (None, None, "model")),
    (r"moe'\]\['w_down'\]$", (None, None, "model")),
]

# expert parallelism: the expert dim over "model"
_MOE_RULES_EP = [
    (r"moe'\]\['w_(gate|up)'\]$", ("model", None, None)),
    (r"moe'\]\['w_down'\]$", ("model", None, None)),
]


def _moe_rules(cfg: ModelConfig, mesh, serve: bool, baseline: bool) -> list:
    """``REPRO_MOE_EP`` first (``1``: expert parallelism, ``0``: tensor
    parallelism); then baseline mode takes tensor parallelism; else
    expert parallelism when the expert count divides the model axis and
    the specs are for training, while serving keeps tensor parallelism
    inside each expert (the reference's rules)."""
    force = os.environ.get("REPRO_MOE_EP", "")
    if force == "1":
        return _MOE_RULES_EP
    if force == "0":
        return _MOE_RULES
    if (not baseline and not serve and cfg.num_experts
            and cfg.num_experts % mesh.shape["model"] == 0):
        return _MOE_RULES_EP
    return _MOE_RULES


def _fit(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """Drop the axes that do not divide their dim."""
    return tuple(None if ax is None or dim % mesh.shape[ax] else ax
                 for dim, ax in zip(shape, spec))


def param_specs(cfg: ModelConfig, mesh, serve: bool = False,
                baseline: Optional[bool] = None) -> Dict:
    """A spec per parameter (a tree shaped as ``param_shapes(cfg)``);
    ``baseline`` None reads ``perf_flags.baseline_mode()``."""
    baseline = baseline_mode(baseline)
    rules = _moe_rules(cfg, mesh, serve, baseline) + _RULES

    def rule_for(path, shape):
        name = keystr(path)
        for pat, spec in rules:
            if re.search(pat, name):
                full = ((None,) + spec if name.startswith("['blocks']")
                        else spec)
                if len(full) != len(shape):
                    return ()
                return _fit(full, shape, mesh)
        return (None,) * len(shape)

    return tree_map(rule_for, param_shapes(cfg))


def opt_specs(cfg: ModelConfig, mesh,
              baseline: Optional[bool] = None) -> Dict:
    """The Adam moments' specs: the params' specs with the first spare
    dim that the data axis divides sharded over ``data`` (ZeRO-1: each
    data rank owns a slice of the moments and updates that slice of the
    params); in baseline mode (``baseline`` None reads
    ``perf_flags.baseline_mode()``) the params' specs."""
    baseline = baseline_mode(baseline)
    ps = param_specs(cfg, mesh, baseline=baseline)
    if baseline or "data" not in mesh.axis_names:
        return {"m": ps, "v": ps, "step": ()}
    dsize = mesh.shape["data"]
    shapes = dict(tree_items(param_shapes(cfg)))

    def zero1(path, spec):
        for i, (ax, dim) in enumerate(zip(spec, shapes[path])):
            if ax is None and dim % dsize == 0 and dim >= dsize:
                return spec[:i] + ("data",) + spec[i + 1:]
        return spec

    ms = tree_map(zero1, ps)
    return {"m": ms, "v": ms, "step": ()}


def _batch_axes(mesh, batch: int):
    """The spec entry of a batch dim: the batch axes (``pod``, ``data``)
    when they divide ``batch``, else None; one axis is named alone, as
    ``PartitionSpec`` normalises it."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bsize = math.prod(mesh.shape[a] for a in baxes)
    if batch % bsize == 0 and batch > 1:
        return baxes[0] if len(baxes) == 1 else baxes
    return None


def batch_specs(cfg: ModelConfig, mesh, batch: int):
    """``spec(leaf_name)`` of a data batch's leaf (``tokens``,
    ``targets``, ``embeds``): the rows over the batch axes when they
    divide ``batch``, else replicated."""
    bspec = _batch_axes(mesh, batch)

    def spec(leaf_name):
        if leaf_name == "embeds":
            return (bspec, None, None)
        return (bspec, None)

    return spec


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int,
                shard_seq: bool = False,
                baseline: Optional[bool] = None) -> Dict:
    """A spec per leaf of ``cache_structs(cfg, batch, max_len)``, the
    reference's rules: the batch dim over the batch axes; KV heads over
    ``model`` where they divide it, else (outside baseline mode) the
    sequence over ``model``; ``shard_seq`` (the batch-1 long-context
    policy) puts the KV sequence over ``data``; mamba's inner dim over
    ``model``; RWKV state and the ``x_prev`` leaves only over the batch.
    ``baseline`` None reads ``perf_flags.baseline_mode()``."""
    baseline = baseline_mode(baseline)
    bspec = _batch_axes(mesh, batch)
    model = mesh.shape["model"]

    def rule_for(path, t):
        name, shape = path[-1], t.shape
        if name in ("k", "v"):                 # (P, B, C, KV, hd)
            seq = ("data" if shard_seq and shape[2] % mesh.shape["data"] == 0
                   else None)
            kv = "model" if shape[3] % model == 0 else None
            if not baseline and kv is None and seq is None \
                    and shape[2] % model == 0:
                seq = "model"
            return (None, bspec, seq, kv, None)
        if name == "h":                        # (P, B, dI, N)
            return (None, bspec, "model" if shape[2] % model == 0 else None,
                    None)
        if name == "conv":                     # (P, B, K-1, dI)
            return (None, bspec, None,
                    "model" if shape[3] % model == 0 else None)
        if name == "s":                        # (P, B, H, hd, hd)
            return (None, bspec, None, None, None)
        return (None, bspec, None)             # x_prev / cm_x_prev

    return tree_map(rule_for, cache_structs(cfg, batch, max_len))


# ------------------------------------------------------------ placement ----


def _axis(entry) -> Optional[str]:
    """A spec entry as one axis name: a batch spec's ``("pod",
    "data")`` is the ``batch`` axis (the mesh's (pod, data) plane), a
    one-name tuple its name."""
    if isinstance(entry, tuple):
        return "batch" if len(entry) > 1 else entry[0]
    return entry


def _coord(mesh, axis) -> Tuple[int, int]:
    """(this rank's index, extent) on ``axis`` (None: 0 of 1)."""
    axis = _axis(axis)
    if axis is None:
        return 0, 1
    if axis == "batch":
        return mesh.batch_rank, mesh.batch
    return ({"data": mesh.data_rank, "model": mesh.model_rank}[axis],
            mesh.shape[axis])


def whole_shape(part: torch.Tensor, spec: Spec, mesh) -> Tuple[int, ...]:
    """The whole tensor's shape from this rank's part of it (a spec
    shorter than the shape, the rules' ``()``, replicates the rest)."""
    return tuple(n * _coord(mesh, spec[d] if d < len(spec) else None)[1]
                 for d, n in enumerate(part.shape))


def shard_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's contiguous block of ``t``: a ``narrow`` on each
    sharded dim at the rank's coordinate on that dim's axis (a view).
    A parameter or moment spec names one axis per dim, or None."""
    for dim, axis in enumerate(spec):
        idx, size = _coord(mesh, axis)
        if size > 1:
            n = t.shape[dim] // size
            t = t.narrow(dim, idx * n, n)
    return t


def _pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """A bool tensor's elements as bits, 8 to a byte (zero padded)."""
    flat = flags.reshape(-1).to(torch.uint8)
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % 8)).view(-1, 8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                           device=flat.device)
    return (flat * weights).sum(1, dtype=torch.uint8)


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[..., None] >> shifts) & 1).reshape(
        *packed.shape[:-1], -1)[..., :n].bool()


def _gather_dim(local: torch.Tensor, dim: int, mesh, axis: str
                ) -> torch.Tensor:
    """Every rank of ``axis``'s group's ``local`` concatenated along
    ``dim``, in rank order.  ``all_gather_concat`` gathers along dim 0,
    so the dim moves to the front and back; a bool tensor travels as
    bits."""
    n = _coord(mesh, axis)[1]
    front = local.movedim(dim, 0).contiguous()
    if front.dtype == torch.bool:
        bits = _pack_bits(front)
        out = torch.empty((n, bits.numel()), dtype=torch.uint8,
                          device=local.device)
        all_gather_concat(out.view(-1), bits, mesh.group(axis))
        whole = _unpack_bits(out, front.numel()).reshape(
            n * front.shape[0], *front.shape[1:])
    else:
        whole = torch.empty((n * front.shape[0], *front.shape[1:]),
                            dtype=front.dtype, device=local.device)
        all_gather_concat(whole, front, mesh.group(axis))
    return whole.movedim(0, dim)


def gather_leaf(local: torch.Tensor, spec: Spec, mesh,
                axes: Sequence[str] = ("batch", "data", "model")
                ) -> torch.Tensor:
    """The whole tensor from every rank's part (a collective over each
    sharded axis's group; ``batch`` (a batch spec's ``("pod",
    "data")``) and ``data`` first, then ``model``).  ``axes``
    limits the gather to those axes: the result is then whole along
    their dims only.  A leaf sharded on no axis comes back as it is."""
    names = [_axis(e) for e in spec]
    for axis in axes:
        if sharded_on(spec, axis, mesh):
            local = _gather_dim(local, names.index(axis), mesh, axis)
    return local


def shard_tree(tree: Dict, specs: Dict, mesh) -> Dict:
    """Each leaf's own block, copied out contiguous so that the whole
    tree can be freed."""
    flat = dict(tree_items(specs))
    return tree_map(lambda p, t: shard_leaf(t, flat[p], mesh).clone(
        memory_format=torch.contiguous_format), tree)


def gather_tree(tree: Dict, specs: Dict, mesh,
                axes: Sequence[str] = ("batch", "data", "model")) -> Dict:
    """``gather_leaf`` over a tree (every rank calls it alike)."""
    flat = dict(tree_items(specs))
    return tree_map(lambda p, t: gather_leaf(t, flat[p], mesh, axes), tree)


def sharded_on(spec: Spec, axis: str, mesh) -> bool:
    """Whether ``spec`` splits a dim over ``axis`` on this mesh."""
    return (axis in [_axis(e) for e in spec]
            and _coord(mesh, axis)[1] > 1)


def resident_bytes(tree: Dict) -> int:
    """The bytes a (sharded) tree's leaves hold on this rank."""
    return sum(t.numel() * t.element_size() for _, t in tree_items(tree))


def whole_bytes(tree: Dict, specs: Dict, mesh) -> int:
    """The bytes of the whole tensors a sharded tree's parts belong to."""
    flat = dict(tree_items(specs))
    return sum(math.prod(whole_shape(t, flat[p], mesh)) * t.element_size()
               for p, t in tree_items(tree))


# -------------------------------------------------- packed serving stack ----

PACKED_COL = {
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
    ("mlp", "w_gate"), ("mlp", "w_up"),
    ("moe", "w_gate"), ("moe", "w_up"),
    ("mamba", "in_proj"), ("mamba", "dt_proj"),
    ("rwkv", "w_r"), ("rwkv", "w_k"), ("rwkv", "w_v"), ("rwkv", "w_g"),
    ("rwkv_cm", "cm_k"),
}
PACKED_ROW = {
    ("attn", "wo"),
    ("mlp", "w_down"),
    ("moe", "w_down"),
    ("mamba", "out_proj"), ("mamba", "x_proj"),
    ("rwkv", "w_o"),
    ("rwkv_cm", "cm_v"),
}


def packed_mode(comp: str, name: str) -> Optional[str]:
    """Shard mode of a packed tensor: "col", "row", or None (replicate)."""
    if (comp, name) in PACKED_COL:
        return "col"
    if (comp, name) in PACKED_ROW:
        return "row"
    return None


def bitmap_sharded(bw: Optional[BitmapWeight], mesh: Mesh) -> bool:
    """Whether ``bw``'s explicit shard axis lines up with the mesh's live
    model axis (the one predicate placement and the gather share)."""
    return (bw is not None and bw.shard is not None
            and mesh.model == bw.shard[1] > 1)


def keep_local(bw: Optional[BitmapWeight], mesh: Mesh
               ) -> Optional[BitmapWeight]:
    """This rank's part of ``bw`` when it is sharded over the mesh's
    model axis (the rest can then be freed), else ``bw`` whole.  The
    part kept is this rank's place on the ``model`` axis."""
    if not bitmap_sharded(bw, mesh):
        return bw
    return keep_part(bw, mesh.model_rank)


def keep_local_tree(tree: Dict, mesh: Mesh) -> Dict:
    """``keep_local`` over a packed block tree (``PackedModel.blocks``),
    in place; ``None`` leaves stay."""
    for bdict in tree.values():
        for tensors in bdict.values():
            for name, bw in tensors.items():
                tensors[name] = keep_local(bw, mesh)
    return tree

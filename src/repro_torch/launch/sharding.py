"""Tensor-parallel rules for the packed serving stack.

Port of the packed-layout part of ``repro/launch/sharding.py``.
Column-parallel tensors split the N tile axis (each shard owns its
output columns); row-parallel tensors split K (per-shard partial
products sum, as ``kernels/ops._sharded_spmm`` composes them).  The LM
head is vocabulary-split (col).  Tensors with no rule (router, SSM decay
and mix tensors, norms) stay replicated.  The reference places shards
with ``PartitionSpec``s; here each rank keeps the shard its place on the
mesh's ``model`` axis names (``keep_local``), and the step gathers them
(``launch/steps.build_serve_step_spmd``).  The dense parameters' rules
are the training half of multi-GPU work and not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.launch.mesh import Mesh
from repro_torch.sparse.format import BitmapWeight, keep_part

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

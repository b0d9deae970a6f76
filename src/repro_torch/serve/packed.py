"""Whole-stack packed model: prune once, pack once, stream the bitmap
format on every decode step.

Port of ``repro/serve/packed.py`` (unsharded).  ``pack_model`` packs
every dispatchable GEMM operand of the params tree, choosing the largest
valid (BK, BN) tile per shape, and records a manifest row per tensor:
packed, or served dense with the reason why.

* Period-stacked 2-D projections (``pack_bitmap_stacked``): attention
  ``wq/wk/wv/wo``, MLP ``w_gate/w_up/w_down``, the MoE ``router`` (and
  the SSM projections, served once those mixers are ported).
* Group-stacked tensors (``pack_bitmap_experts``): the MoE expert
  stacks ``w_gate/w_up/w_down``, (P, E, K, N), whose per-period
  (E, ...) weight goes through ``kernels/ops.bitmap_spmm_grouped``
  (and rwkv's ``mix_B``, which shares the layout).

Packing is lossless (budget = the largest tile non-zero count), so the
packed stream computes what dense dispatch of the same pruned weights
computes.  Router-gated expert stacks count per *activated* expert in
the modeled bytes (``stream_report(activated_experts=...)`` scales them
by ``min(E, activated) / E``, packed or not), as the reference models a
gather dispatch.  The capacity dispatch both packages run *executes* all
E experts every step: the modeled figure is not the executed one.

``pack_model(shards=S)`` packs every tensor with a tensor-parallel rule
(``launch/sharding.py``) in the sharded layout (``shard_bitmap``), its
tile chosen against the per-shard slice, so that each of S ranks can
keep 1/S of it; a tensor whose sharded dim S does not divide, or whose
slice no tile fits, stays replicated with a typed ``shard_reason``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.launch.sharding import packed_mode
from repro_torch.sparse.format import (BitmapWeight, pack_bitmap_experts,
                                       pack_bitmap_stacked, shard_bitmap)

# (component, tensor) pairs with a compressed dispatch path in the decode
# step.  2-D entries are period-stacked projections; GROUPED entries are
# (P, G, K, N) stacks dispatched per group.  Everything else records a
# fallback reason in the manifest.
DISPATCHABLE_2D = {
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
    ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"),
    ("moe", "router"),
    ("mamba", "in_proj"), ("mamba", "x_proj"), ("mamba", "dt_proj"),
    ("mamba", "out_proj"),
    ("rwkv", "w_r"), ("rwkv", "w_k"), ("rwkv", "w_v"), ("rwkv", "w_g"),
    ("rwkv", "w_o"), ("rwkv", "decay_A"), ("rwkv", "decay_B"),
    ("rwkv", "mix_A"),
    ("rwkv_cm", "cm_k"), ("rwkv_cm", "cm_v"), ("rwkv_cm", "cm_r"),
}
DISPATCHABLE_GROUPED = {
    ("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down"),
    ("rwkv", "mix_B"),
}
# router-gated expert stacks: per-step traffic scales with *activated*
# experts (rwkv's mix_B is group-stacked but always fully active)
ROUTED_EXPERT = {("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down")}


def activated_scale(experts: int, activated: Optional[int]) -> float:
    """The accounting rule: router-gated expert stacks stream
    ``min(E, activated)`` of their ``E`` stored experts per step
    (``experts == 0`` or ``activated is None``: no scaling)."""
    if not experts or activated is None:
        return 1.0
    return min(experts, activated) / experts


def choose_block(k: int, n: int, cap: int = 128
                 ) -> Optional[Tuple[int, int]]:
    """Largest (BK, BN) bitmap tile dividing (k, n); BN % 8 == 0."""
    bk = next((d for d in range(min(k, cap), 0, -1) if k % d == 0), None)
    bn = next((d for d in range(min(n, cap), 0, -1)
               if n % d == 0 and d % 8 == 0), None)
    if bk is None or bn is None:
        return None
    return bk, bn


@dataclasses.dataclass
class PackEntry:
    """Manifest row: one tensor's pack decision and its stored-stack
    bytes (all periods, all experts).  ``layout`` is "stacked"
    (period-stacked 2-D), "grouped" (expert/group stack) or "dense"
    (fallback); ``experts`` is the stored expert count of a router-gated
    stack (0 otherwise)."""

    path: str
    shape: Tuple[int, ...]
    packed: bool
    reason: str                      # "" when packed, else why dense
    block: Optional[Tuple[int, int]]
    sparsity: float                  # measured zero fraction
    sparse_bytes: int                # streamed per step on the chosen path
    dense_bytes: int
    layout: str = "dense"
    experts: int = 0
    #: ("col"|"row", S) when the packed tensor carries an explicit shard
    #: axis; None for replicated or unsharded tensors
    shard: Optional[Tuple[str, int]] = None
    #: why a tensor with a tensor-parallel rule could not shard (stored
    #: replicated); "" when sharded or when no rule applies
    shard_reason: str = ""


@dataclasses.dataclass
class PackedModel:
    """The packed tree (mirrors ``params["blocks"]``) and its manifest;
    ``shards`` is the model-axis shard count it was packed for."""

    blocks: Dict
    manifest: List[PackEntry]
    shards: int = 1

    @property
    def packed_entries(self) -> List[PackEntry]:
        return [e for e in self.manifest if e.packed]

    @property
    def fallback_entries(self) -> List[PackEntry]:
        return [e for e in self.manifest if not e.packed]

    def leaves(self) -> List[Tuple[str, BitmapWeight]]:
        """Every packed ``(path, BitmapWeight)``, manifest order."""
        return [(f"blocks/{b}/{c}/{n}", bw)
                for b, bd in self.blocks.items()
                for c, tensors in bd.items()
                for n, bw in tensors.items() if bw is not None]

    def replace_leaf(self, path: str, bw: Optional[BitmapWeight]) -> None:
        """Swap the leaf at ``path`` (fault injection writes a corrupted
        copy; quarantine writes ``None``)."""
        _, bname, comp, name = path.split("/")
        assert name in self.blocks[bname][comp], path
        self.blocks[bname][comp][name] = bw

    def quarantine(self, path: str, reason: str) -> bool:
        """Serve ``path`` dense from now on: the leaf becomes ``None``
        (``layers.matmul_or_bitmap`` then multiplies by the dense params
        tensor) and its manifest entry flips to a fallback carrying
        ``reason``, so ``stream_report()`` reflects the quarantine.
        Returns False if the leaf is already dense."""
        _, bname, comp, name = path.split("/")
        if self.blocks.get(bname, {}).get(comp, {}).get(name) is None:
            return False
        self.blocks[bname][comp][name] = None
        for e in self.manifest:
            if e.path == path:
                e.packed = False
                e.reason = reason
                e.layout = "dense"
                e.block = None
                e.sparse_bytes = e.dense_bytes
                e.shard = None
        return True

    def register_metrics(self, reg) -> None:
        reg.gauge("stream.packed_tensors",
                  lambda: len(self.packed_entries))
        reg.gauge("stream.fallback_tensors",
                  lambda: len(self.fallback_entries))

    def stream_report(self, activated_experts: Optional[int] = None
                      ) -> Dict:
        """Modeled per-step weight bytes across the stack (no head — the
        engine adds its head term on top).  ``activated_experts`` (the
        engine passes ``num_slots × top_k``) scales router-gated expert
        stacks by ``min(E, activated) / E`` on the sparse and the dense
        side alike.  The ``device_*`` figures are one rank's: a sharded
        tensor counts 1/S of its bytes."""
        def step_bytes(e: PackEntry, attr: str) -> int:
            return int(round(getattr(e, attr)
                             * activated_scale(e.experts,
                                               activated_experts)))

        sparse = sum(step_bytes(e, "sparse_bytes") for e in self.manifest)
        dense = sum(step_bytes(e, "dense_bytes") for e in self.manifest)
        return {
            "sparse_bytes_per_step": sparse,
            "dense_bytes_per_step": dense,
            "reduction": dense / sparse if sparse else 1.0,
            "packed_tensors": len(self.packed_entries),
            "fallback_tensors": len(self.fallback_entries),
            "activated_experts": activated_experts,
            "fallbacks": {e.path: e.reason for e in self.fallback_entries},
            "shards": self.shards,
            "device_sparse_bytes_per_step": sum(
                entry_device_bytes(e, "sparse_bytes", activated_experts)
                for e in self.manifest),
            "device_dense_bytes_per_step": sum(
                entry_device_bytes(e, "dense_bytes", activated_experts)
                for e in self.manifest),
            "shard_fallbacks": {e.path: e.shard_reason
                                for e in self.manifest if e.shard_reason},
        }


def entry_device_bytes(e: PackEntry, attr: str,
                       activated: Optional[int]) -> int:
    """One manifest row's per-step bytes on one rank: the aggregate
    accounting ``int(round(bytes × activated_scale))`` divided by the
    tensor's shard count, so that the traffic ledger's per-rank rows sum
    to the engine's device aggregates by construction."""
    b = int(round(getattr(e, attr) * activated_scale(e.experts,
                                                     activated)))
    return b // e.shard[1] if e.shard is not None else b


def _shard_block(comp: str, name: str, k: int, n: int, cap: int,
                 shards: int) -> Tuple[Optional[Tuple[int, int]],
                                       Optional[Tuple[str, int]], str]:
    """(block, shard, shard_reason) of one tensor.  With ``shards == 1``
    or no rule for (comp, name), ``choose_block`` and no shard.  Else the
    tile is chosen against the per-shard slice, (k, n/S) column-parallel
    or (k/S, n) row-parallel, so that every shard's range is whole
    tiles; a dim S does not divide, or a slice no tile fits, stays
    replicated with a typed reason."""
    mode = shards > 1 and packed_mode(comp, name) or None
    if not mode:
        return choose_block(k, n, cap), None, ""
    dim, dim_name = (n, "N") if mode == "col" else (k, "K")
    if dim % shards != 0:
        return choose_block(k, n, cap), None, (
            f"shard: {dim_name}={dim} not divisible by {shards} shards; "
            f"stored replicated")
    block = (choose_block(k, n // shards, cap) if mode == "col"
             else choose_block(k // shards, n, cap))
    if block is None:
        return choose_block(k, n, cap), None, (
            f"shard: no (BK, BN) tile fits the per-shard "
            f"{'column' if mode == 'col' else 'row'} slice; "
            f"stored replicated")
    return block, (mode, shards), ""


def _pack_leaf(path: str, comp: str, name: str, w: torch.Tensor, cap: int,
               cache_dense: bool, shards: int = 1
               ) -> Tuple[PackEntry, Optional[BitmapWeight]]:
    dense_bytes = w.numel() * w.element_size()
    sparsity = 1.0 - int(torch.count_nonzero(w)) / max(w.numel(), 1)
    key = (comp, name)
    # the activated-expert accounting applies to router-gated stacks
    # whether they pack or fall back
    routed = w.shape[1] if key in ROUTED_EXPERT and w.dim() == 4 else 0

    def fallback(reason: str) -> Tuple[PackEntry, None]:
        return PackEntry(path=path, shape=tuple(w.shape), packed=False,
                         reason=reason, block=None, sparsity=sparsity,
                         sparse_bytes=dense_bytes,
                         dense_bytes=dense_bytes, experts=routed), None

    if key in DISPATCHABLE_GROUPED:
        if w.dim() != 4:             # (P, G, K, N) = period × group stack
            return fallback(f"group stack with unexpected rank "
                            f"(ndim={w.dim()}, want 4)")
        layout, pack = "grouped", pack_bitmap_experts
    elif key in DISPATCHABLE_2D:
        if w.dim() != 3:             # (P, K, N) = period-stacked projection
            return fallback(f"not a 2-D projection (ndim={w.dim() - 1})")
        layout, pack = "stacked", pack_bitmap_stacked
    else:
        # every GEMM operand of the decode step is listed above; the rest
        # are elementwise/state/conv tensors with no matmul to compress
        return fallback("not a GEMM operand (elementwise/state/conv tensor)")
    k, n = w.shape[-2:]
    block, shard, shard_reason = _shard_block(comp, name, k, n, cap, shards)
    if block is None:
        return fallback(f"no (BK, BN) tile divides ({k}, {n}) with BN % 8")
    bw = pack(w, block=block, cache_dense=cache_dense)
    if shard is not None:
        bw = shard_bitmap(bw, shard[1], shard[0])
    return PackEntry(path=path, shape=tuple(w.shape), packed=True, reason="",
                     block=block, sparsity=sparsity,
                     sparse_bytes=bw.hbm_bytes, dense_bytes=dense_bytes,
                     layout=layout, experts=routed, shard=shard,
                     shard_reason=shard_reason), bw


def pack_model(params: Dict, cap: int = 128, cache_dense: bool = False,
               shards: int = 1) -> PackedModel:
    """Pack every dispatchable decode-step GEMM operand of ``params``
    (on the device the params lie on).  ``cache_dense`` attaches a dense
    rendering per tensor for the plain version on the CPU; it never
    counts toward the modeled bytes and is never made on the card.
    ``shards`` > 1 packs every tensor with a tensor-parallel rule in the
    sharded layout (see the module docstring)."""
    manifest: List[PackEntry] = []
    packed_blocks: Dict = {}
    for bname, bdict in params["blocks"].items():
        packed_b: Dict = {}
        for comp, tensors in bdict.items():
            packed_c: Dict = {}
            for name, w in tensors.items():
                entry, bw = _pack_leaf(f"blocks/{bname}/{comp}/{name}",
                                       comp, name, w, cap, cache_dense,
                                       shards)
                manifest.append(entry)
                packed_c[name] = bw
            packed_b[comp] = packed_c
        packed_blocks[bname] = packed_b
    return PackedModel(blocks=packed_blocks, manifest=manifest,
                       shards=shards)

"""Whole-stack packed model: prune once, pack once, stream the bitmap
format on every decode step.

Port of ``repro/serve/packed.py`` (its 2-D period-stacked path).
``pack_model`` packs every dispatchable decode-step GEMM operand of the
params tree into one period-stacked ``BitmapWeight`` per tensor,
choosing the largest valid (BK, BN) tile per shape, and records a
manifest row per tensor: packed, or served dense with the reason why.
Packing is lossless (budget = the largest tile non-zero count), so the
packed stream computes what dense dispatch of the same pruned weights
computes.  Group-stacked tensors (MoE experts, rwkv ``mix_B``) and
sharded layouts are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.sparse.format import BitmapWeight, pack_bitmap_stacked

# (component, tensor) pairs with a compressed dispatch path in the decode
# step; everything else records a fallback reason in the manifest
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
    """Manifest row: one tensor's pack decision and its modeled per-step
    bytes (all periods).  ``layout`` is "stacked" or "dense"."""

    path: str
    shape: Tuple[int, ...]
    packed: bool
    reason: str                      # "" when packed, else why dense
    block: Optional[Tuple[int, int]]
    sparsity: float                  # measured zero fraction
    sparse_bytes: int                # streamed per step on the chosen path
    dense_bytes: int
    layout: str = "dense"


@dataclasses.dataclass
class PackedModel:
    """The packed tree (mirrors ``params["blocks"]``) and its manifest."""

    blocks: Dict
    manifest: List[PackEntry]

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

    def stream_report(self) -> Dict:
        """Modeled per-step weight bytes across the stack (no head — the
        engine adds its head term on top)."""
        sparse = sum(e.sparse_bytes for e in self.manifest)
        dense = sum(e.dense_bytes for e in self.manifest)
        return {
            "sparse_bytes_per_step": sparse,
            "dense_bytes_per_step": dense,
            "reduction": dense / sparse if sparse else 1.0,
            "packed_tensors": len(self.packed_entries),
            "fallback_tensors": len(self.fallback_entries),
            "activated_experts": None,
            "fallbacks": {e.path: e.reason for e in self.fallback_entries},
        }


def _pack_leaf(path: str, comp: str, name: str, w: torch.Tensor, cap: int,
               cache_dense: bool) -> Tuple[PackEntry, Optional[BitmapWeight]]:
    dense_bytes = w.numel() * w.element_size()
    sparsity = 1.0 - int(torch.count_nonzero(w)) / max(w.numel(), 1)

    def fallback(reason: str) -> Tuple[PackEntry, None]:
        return PackEntry(path=path, shape=tuple(w.shape), packed=False,
                         reason=reason, block=None, sparsity=sparsity,
                         sparse_bytes=dense_bytes,
                         dense_bytes=dense_bytes), None

    if (comp, name) not in DISPATCHABLE_2D:
        # every 2-D GEMM operand of the decode step is listed above; the
        # rest are elementwise/state/conv tensors with no matmul to compress
        return fallback("not a GEMM operand (elementwise/state/conv tensor)")
    if w.dim() != 3:                 # (P, K, N) = period-stacked projection
        return fallback(f"not a 2-D projection (ndim={w.dim() - 1})")
    _, k, n = w.shape
    block = choose_block(k, n, cap)
    if block is None:
        return fallback(f"no (BK, BN) tile divides ({k}, {n}) with BN % 8")
    bw = pack_bitmap_stacked(w, block=block, cache_dense=cache_dense)
    return PackEntry(path=path, shape=tuple(w.shape), packed=True, reason="",
                     block=block, sparsity=sparsity,
                     sparse_bytes=bw.hbm_bytes, dense_bytes=dense_bytes,
                     layout="stacked"), bw


def pack_model(params: Dict, cap: int = 128,
               cache_dense: bool = False) -> PackedModel:
    """Pack every dispatchable decode-step GEMM operand of ``params``
    (on the device the params lie on).  ``cache_dense`` attaches a dense
    rendering per tensor for the plain version on the CPU; it never
    counts toward the modeled bytes and is never made on the card."""
    manifest: List[PackEntry] = []
    packed_blocks: Dict = {}
    for bname, bdict in params["blocks"].items():
        packed_b: Dict = {}
        for comp, tensors in bdict.items():
            packed_c: Dict = {}
            for name, w in tensors.items():
                entry, bw = _pack_leaf(f"blocks/{bname}/{comp}/{name}",
                                       comp, name, w, cap, cache_dense)
                manifest.append(entry)
                packed_c[name] = bw
            packed_b[comp] = packed_c
        packed_blocks[bname] = packed_b
    return PackedModel(blocks=packed_blocks, manifest=manifest)

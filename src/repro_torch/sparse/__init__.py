"""Sparse weight format and pruning of the port."""
from repro_torch.sparse.format import (BitmapWeight, pack_bitmap,
                                       pack_bitmap_experts,
                                       pack_bitmap_stacked, unpack_bitmap,
                                       unpack_bitmap_experts,
                                       unpack_bitmap_stacked)
from repro_torch.sparse.pruning import (global_l1_prune, per_tensor_prune,
                                        sparsity_of)

__all__ = ["BitmapWeight", "global_l1_prune", "pack_bitmap",
           "pack_bitmap_experts", "pack_bitmap_stacked", "per_tensor_prune",
           "sparsity_of", "unpack_bitmap", "unpack_bitmap_experts",
           "unpack_bitmap_stacked"]

"""Sparse weight formats and pruning of the port."""
from repro_torch.sparse.format import (BitmapWeight, BlockSparseWeight,
                                       pack_bitmap, pack_bitmap_experts,
                                       pack_bitmap_stacked, pack_block_sparse,
                                       unpack_bitmap, unpack_bitmap_experts,
                                       unpack_bitmap_stacked,
                                       unpack_block_sparse)
from repro_torch.sparse.nm import NmWeight, pack_nm, prune_nm, unpack_nm
from repro_torch.sparse.pruning import (global_l1_prune, per_tensor_prune,
                                        sparsity_of)

__all__ = ["BitmapWeight", "BlockSparseWeight", "NmWeight",
           "global_l1_prune", "pack_bitmap", "pack_bitmap_experts",
           "pack_bitmap_stacked", "pack_block_sparse", "pack_nm",
           "per_tensor_prune", "prune_nm", "sparsity_of", "unpack_bitmap",
           "unpack_bitmap_experts", "unpack_bitmap_stacked",
           "unpack_block_sparse", "unpack_nm"]

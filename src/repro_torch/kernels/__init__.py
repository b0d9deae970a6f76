"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the dispatch between them (``ops``).

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one only where it launches its kernel, so a run can show that its
main path went through the kernels.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"bitmap_spmm": 0, "bitmap_spmm_grouped": 0,
                             "flash_attention": 0,
                             "block_sparse_matmul": 0, "nm_spmm": 0,
                             "decode_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

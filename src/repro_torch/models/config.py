"""Model configuration for the unified decoder stack.

A model is ``num_periods`` repetitions of a heterogeneous ``pattern`` of
blocks (mixer + ffn); homogeneous archs use a period of one block.  The
pattern mechanism expresses gemma3's 5 local : 1 global attention, jamba's
1:7 attn:mamba interleave with MoE every other layer, etc., while keeping
``lax.scan`` over periods (O(1) HLO depth).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One block of the repeating pattern."""

    mixer: str = "attn"          # attn | mamba | rwkv
    ffn: str = "mlp"             # mlp | moe | rwkv_cm | none
    window: Optional[int] = None  # sliding-window size for local attention


@dataclasses.dataclass(frozen=True)
class SparsityCfg:
    """The paper's technique as a framework feature."""

    enabled: bool = False
    sparsity: float = 0.75        # global L1 target (paper: 75 %)
    format: str = "bitmap"        # bitmap | block — serving weight format
    block: Tuple[int, int] = (128, 128)
    masked_training: bool = True  # keep pruned weights at zero during training


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[BlockCfg, ...] = (BlockCfg(),)
    head_dim: Optional[int] = None
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    rwkv_head_dim: int = 64
    # misc
    norm: str = "rmsnorm"         # rmsnorm | ln_nonparam | ln
    qk_norm: bool = False
    act: str = "silu"             # silu | gelu | relu
    rope_theta: float = 10_000.0
    max_seq_len: int = 131_072
    tie_embeddings: bool = True
    embed_scale: bool = False     # gemma-style sqrt(d) embedding scale
    logit_softcap: Optional[float] = None
    # modality frontend stub: number of precomputed embedding positions
    frontend: Optional[str] = None   # None | "patches" | "frames"
    frontend_len: int = 0            # patch positions prepended (vlm)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # technique
    sparsity: SparsityCfg = SparsityCfg()
    # training-memory knobs
    remat: bool = True
    loss_chunk: int = 512         # sequence chunk for the CE loss
    scan_layers: bool = True

    def __post_init__(self):
        assert self.num_layers % len(self.pattern) == 0, (
            self.name, self.num_layers, len(self.pattern))
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_ssm_or_hybrid(self) -> bool:
        return any(b.mixer in ("mamba", "rwkv") for b in self.pattern)

    @property
    def fully_quadratic(self) -> bool:
        """True if every mixer is full (global) attention."""
        return all(b.mixer == "attn" and b.window is None
                   for b in self.pattern)

    def param_count(self) -> int:
        """Exact parameter count from the shape inventory."""
        from repro_torch.models.model import param_shapes  # lazy, avoids cycle
        shapes = param_shapes(self)
        import math
        total = 0
        for leaf in _tree_leaves(shapes):
            total += math.prod(leaf)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts)."""
        if self.num_experts == 0:
            return self.param_count()
        from repro_torch.models.model import param_shapes
        import math
        shapes = param_shapes(self)
        total = 0
        for path, leaf in _tree_items(shapes):
            n = math.prod(leaf)
            if "moe" in path and "router" not in path:
                n = n * self.top_k // self.num_experts
            total += n
        return total


def _tree_leaves(d, out=None):
    out = [] if out is None else out
    for v in d.values():
        if isinstance(v, dict):
            _tree_leaves(v, out)
        else:
            out.append(v)
    return out


def _tree_items(d, prefix="", out=None):
    out = [] if out is None else out
    for k, v in d.items():
        p = f"{prefix}/{k}"
        if isinstance(v, dict):
            _tree_items(v, p, out)
        else:
            out.append((p, v))
    return out

"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Mamba : attention 7:1 interleave (attention at period index 3), MoE 16
experts top-2 on every other layer.  [arXiv:2403.19887; hf]
"""
from repro_torch.models.config import BlockCfg, ModelConfig


def _pattern():
    blocks = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        blocks.append(BlockCfg(mixer=mixer, ffn=ffn))
    return tuple(blocks)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        d_model=4096, num_layers=32, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        pattern=_pattern(),
        num_experts=16, top_k=2,
        mamba_d_state=16, mamba_expand=2, mamba_conv=4,
        norm="rmsnorm", act="silu", rope_theta=10_000.0,
        tie_embeddings=False, max_seq_len=262_144,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        d_model=64, num_layers=8, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        pattern=_pattern(),
        num_experts=4, top_k=2,
        mamba_d_state=4, mamba_expand=2, mamba_conv=4,
        norm="rmsnorm", act="silu", tie_embeddings=False, max_seq_len=64,
    )

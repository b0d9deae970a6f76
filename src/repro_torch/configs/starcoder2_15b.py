"""starcoder2-15b [dense]: 40L d=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.

GQA + RoPE, ungated GELU MLP, standard LayerNorm.  Pure full attention —
long_500k is skipped for this arch (DESIGN.md §4).  [arXiv:2402.19173; hf]
"""
from repro_torch.models.config import BlockCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        d_model=6144, num_layers=40, num_heads=48, num_kv_heads=4,
        d_ff=24576, vocab_size=49152,
        pattern=(BlockCfg(mixer="attn"),),
        norm="ln", act="gelu", rope_theta=100_000.0,
        tie_embeddings=False, max_seq_len=16_384,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke",
        d_model=64, num_layers=2, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        pattern=(BlockCfg(mixer="attn"),),
        norm="ln", act="gelu", tie_embeddings=False, max_seq_len=64,
    )

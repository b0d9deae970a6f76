"""musicgen-medium [audio]: 48L d=1536 24H (kv=24) d_ff=6144 vocab=2048.

Decoder-only transformer over EnCodec tokens.  The EnCodec frontend is a
STUB per the assignment: ``input_specs`` provides precomputed frame
embeddings (B, S, D); the LM head predicts the next codec token (vocab
2048).  Positional encoding adapted to RoPE (DESIGN.md §4).
[arXiv:2306.05284; hf]
"""
from repro_torch.models.config import BlockCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        d_model=1536, num_layers=48, num_heads=24, num_kv_heads=24,
        d_ff=6144, vocab_size=2048,
        pattern=(BlockCfg(mixer="attn"),),
        norm="ln", act="gelu", rope_theta=10_000.0,
        tie_embeddings=False, max_seq_len=32_768,
        frontend="frames",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        d_model=64, num_layers=2, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128,
        pattern=(BlockCfg(mixer="attn"),),
        norm="ln", act="gelu", tie_embeddings=False, max_seq_len=64,
        frontend="frames",
    )

"""rwkv6-3b [ssm]: 32L d=2560 (attn-free) d_ff=8960 vocab=65536.

RWKV-6 "Finch" — data-dependent decay time-mix + squared-relu channel-mix.
State-based decode makes the 500k-context cell natural.  [arXiv:2404.05892]
"""
from repro_torch.models.config import BlockCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        d_model=2560, num_layers=32, num_heads=40, num_kv_heads=40,
        d_ff=8960, vocab_size=65536, rwkv_head_dim=64,
        pattern=(BlockCfg(mixer="rwkv", ffn="rwkv_cm"),),
        norm="ln", act="relu",
        tie_embeddings=False, max_seq_len=1_048_576,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        d_model=64, num_layers=2, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, rwkv_head_dim=16,
        pattern=(BlockCfg(mixer="rwkv", ffn="rwkv_cm"),),
        norm="ln", act="relu", tie_embeddings=False, max_seq_len=64,
    )

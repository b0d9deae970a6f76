"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

5:1 local:global attention interleave (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.models.config import BlockCfg, ModelConfig

_PATTERN = tuple([BlockCfg(mixer="attn", window=1024)] * 5
                 + [BlockCfg(mixer="attn", window=None)])


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        d_model=3840, num_layers=48, num_heads=16, num_kv_heads=8,
        d_ff=15360, vocab_size=262144, head_dim=256,
        pattern=_PATTERN, qk_norm=True, embed_scale=True,
        norm="rmsnorm", act="silu", rope_theta=1_000_000.0,
        tie_embeddings=True, max_seq_len=131_072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-smoke",
        d_model=64, num_layers=6, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        pattern=tuple([BlockCfg(mixer="attn", window=8)] * 5
                      + [BlockCfg(mixer="attn")]),
        qk_norm=True, embed_scale=True, norm="rmsnorm", act="silu",
        max_seq_len=64,
    )

"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) per-expert d_ff=512,
MoE 40 experts top-8, vocab=49155.  [hf:ibm-granite/granite-3.0-1b-a400m]
"""
from repro_torch.models.config import BlockCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        d_model=1536, num_layers=32, num_heads=24, num_kv_heads=8,
        d_ff=512, vocab_size=49_155,
        pattern=(BlockCfg(mixer="attn", ffn="moe"),),
        num_experts=40, top_k=8,
        norm="rmsnorm", act="silu", rope_theta=10_000.0,
        tie_embeddings=True, max_seq_len=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke",
        d_model=64, num_layers=2, num_heads=4, num_kv_heads=2,
        d_ff=32, vocab_size=255,  # deliberately non-divisible, like 49155
        pattern=(BlockCfg(mixer="attn", ffn="moe"),),
        num_experts=5, top_k=2,
        norm="rmsnorm", act="silu", max_seq_len=64,
    )

"""olmo-1b [dense]: 16L d=2048 16H (GQA kv=16 = MHA) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (the OLMo signature).  [arXiv:2402.00838; hf]
"""
from repro_torch.models.config import BlockCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        d_model=2048, num_layers=16, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304,
        pattern=(BlockCfg(mixer="attn"),),
        norm="ln_nonparam", act="silu", rope_theta=10_000.0,
        tie_embeddings=True, max_seq_len=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke",
        d_model=64, num_layers=2, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        pattern=(BlockCfg(mixer="attn"),),
        norm="ln_nonparam", act="silu", max_seq_len=64,
    )

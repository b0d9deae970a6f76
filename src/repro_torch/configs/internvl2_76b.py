"""internvl2-76b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT + LLaMA-3-70B-class backbone.  The InternViT frontend is a STUB
per the assignment: ``input_specs`` provides 256 precomputed patch
embeddings prepended to the token sequence; loss is masked over the patch
region.  [arXiv:2404.16821; unverified]
"""
from repro_torch.models.config import BlockCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        d_model=8192, num_layers=80, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128_256,
        pattern=(BlockCfg(mixer="attn"),),
        norm="rmsnorm", act="silu", rope_theta=500_000.0,
        tie_embeddings=False, max_seq_len=32_768,
        frontend="patches", frontend_len=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke",
        d_model=64, num_layers=2, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        pattern=(BlockCfg(mixer="attn"),),
        norm="rmsnorm", act="silu", tie_embeddings=False, max_seq_len=64,
        frontend="patches", frontend_len=4,
    )

"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) per-expert d_ff=1408,
MoE 64 experts top-6, vocab=163840.  [hf:moonshotai/Moonlight-16B-A3B]

NOTE: the assigned hyperparameters give 27.7B total / 3.6B active params —
active matches the "a3b" moniker; the "16b" nameplate would require a
different expert shape than assigned. We implement the assignment exactly.
"""
from repro_torch.models.config import BlockCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        d_model=2048, num_layers=48, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=163_840,
        pattern=(BlockCfg(mixer="attn", ffn="moe"),),
        num_experts=64, top_k=6,
        norm="rmsnorm", act="silu", rope_theta=50_000.0,
        tie_embeddings=True, max_seq_len=8192,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke",
        d_model=64, num_layers=2, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=256,
        pattern=(BlockCfg(mixer="attn", ffn="moe"),),
        num_experts=8, top_k=2,
        norm="rmsnorm", act="silu", max_seq_len=64,
    )

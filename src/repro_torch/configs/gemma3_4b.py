"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global, 128k.  34 layers do not tile by a 6-block period, so the
pattern is one 17-block half (15 local : 2 global, globals at 5 and 11)
repeated twice — the closest 5:1 tiling of 34 layers (DESIGN.md §4).
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.models.config import BlockCfg, ModelConfig

_L = BlockCfg(mixer="attn", window=1024)
_G = BlockCfg(mixer="attn", window=None)
_PATTERN = (_L, _L, _L, _L, _L, _G, _L, _L, _L, _L, _L, _G, _L, _L, _L, _L,
            _L)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        d_model=2560, num_layers=34, num_heads=8, num_kv_heads=4,
        d_ff=10240, vocab_size=262144, head_dim=256,
        pattern=_PATTERN, qk_norm=True, embed_scale=True,
        norm="rmsnorm", act="silu", rope_theta=1_000_000.0,
        tie_embeddings=True, max_seq_len=131_072,
    )


def smoke_config() -> ModelConfig:
    sl = BlockCfg(mixer="attn", window=8)
    sg = BlockCfg(mixer="attn")
    return ModelConfig(
        name="gemma3-4b-smoke",
        d_model=64, num_layers=6, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        pattern=(sl, sl, sg, sl, sl, sg), qk_norm=True, embed_scale=True,
        norm="rmsnorm", act="silu", max_seq_len=64,
    )

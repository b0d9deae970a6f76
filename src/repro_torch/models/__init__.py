"""Decoder model of the port (decode path) and its configuration."""
from repro_torch.models.config import BlockCfg, ModelConfig, SparsityCfg

__all__ = ["BlockCfg", "ModelConfig", "SparsityCfg"]

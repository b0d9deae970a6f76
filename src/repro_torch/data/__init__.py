"""Deterministic sharded synthetic data pipeline."""
from repro_torch.data.pipeline import DataConfig, Prefetcher, synth_batch

__all__ = ["DataConfig", "Prefetcher", "synth_batch"]

"""Training substrate: optimizer, checkpointing, gradient compression."""
from repro_torch.train.optimizer import OptConfig

__all__ = ["OptConfig"]

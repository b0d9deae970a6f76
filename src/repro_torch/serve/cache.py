"""Slotted KV-cache manager.

One ``init_cache`` allocation (batch = num_slots) lives for the engine's
lifetime; every cache tensor carries the slot dimension at axis 1 (axis
0 is the period-stacked layer dim), so admitting a request into a freed
slot zeroes that slot's lines in place — storage is reused across
request lifetimes, never reallocated.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache


class SlotKVCache:
    """The engine's decode cache on ``device`` (``cuda`` unless named,
    ``NoCudaDevice`` without a card)."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 device: torch.device | str | None = None):
        self.num_slots = num_slots
        self.max_len = max_len
        self.cache = init_cache(cfg, num_slots, max_len, device=device)
        self.resets = 0

    def reset_slot(self, slot: int) -> None:
        """Zero one slot's lines across every layer (fresh request)."""
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} outside [0, {self.num_slots})")
        for leaf in self.cache.values():
            for t in leaf.values():
                t[:, slot].zero_()
        self.resets += 1

    def reserved_kv_bytes(self) -> int:
        """Bytes reserved for attention KV lines (num_slots × capacity)."""
        return sum(t.numel() * t.element_size()
                   for leaf in self.cache.values()
                   for name, t in leaf.items() if name in ("k", "v"))

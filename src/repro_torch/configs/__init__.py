"""Architecture registry: 10 assigned archs × their input-shape sets.

``get_config(arch)`` / ``get_smoke_config(arch)`` return ``ModelConfig``s;
``SHAPES`` defines the four LM shape cells; ``cells()`` enumerates every
runnable (arch × shape) pair with skips applied per DESIGN.md §4
(long_500k only for sub-quadratic archs; all archs are decoder-style so
decode shapes run everywhere).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma3-12b": "gemma3_12b",
    "olmo-1b": "olmo_1b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma3-4b": "gemma3_4b",
    "rwkv6-3b": "rwkv6_3b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "musicgen-medium": "musicgen_medium",
    "internvl2-76b": "internvl2_76b",
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)

# archs whose attention is sub-quadratic enough for the 500k decode cell
# (SSM / hybrid / mostly-sliding-window); pure full-attention archs skip it.
LONG_CONTEXT_ARCHS = frozenset(
    {"rwkv6-3b", "jamba-v0.1-52b", "gemma3-12b", "gemma3-4b"})


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"
    official: bool = True  # part of the assigned 40-cell matrix


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
    # extra analysis cell (EXPERIMENTS §Perf cell 3): low-latency serving —
    # the weight-streaming-bound regime the paper's technique targets
    "decode_2k_b8": ShapeCfg("decode_2k_b8", 2048, 8, "decode",
                             official=False),
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.config()


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke_config()


def shape_supported(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 500k decode skipped"
    return True, ""


def cells(include_skipped: bool = False) -> List[Tuple[str, str, str]]:
    """All (arch, shape, skip_reason) dry-run cells (official matrix)."""
    out = []
    for arch in ARCHS:
        for shape, cfg in SHAPES.items():
            if not cfg.official:
                continue
            ok, reason = shape_supported(arch, shape)
            if ok or include_skipped:
                out.append((arch, shape, "" if ok else reason))
    return out

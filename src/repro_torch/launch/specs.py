"""Meta-tensor stand-ins for every model input (allocation-free).

Port of ``repro/launch/specs.py``: ``input_specs(cfg, shape)`` returns
the inputs a step is counted on in the dry run (``launch/dryrun.py``) as
meta tensors, the reference's ``ShapeDtypeStruct`` shapes, with the
port's token type (int64, what its steps index with).  Modality
frontends are stubs, as in the reference: [audio] gets precomputed frame
embeddings, [vlm] patch embeddings prepended.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import ShapeCfg
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DTYPES, cache_structs


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict:
    """The train (or prefill) batch: tokens / embeds and targets."""
    b, s = shape.global_batch, shape.seq_len
    dt, i64 = DTYPES[cfg.compute_dtype], torch.int64
    if cfg.frontend == "frames":
        return {"embeds": _meta((b, s, cfg.d_model), dt),
                "targets": _meta((b, s), i64)}
    if cfg.frontend == "patches":
        fl = cfg.frontend_len
        return {"embeds": _meta((b, fl, cfg.d_model), dt),
                "tokens": _meta((b, s - fl), i64),
                "targets": _meta((b, s), i64)}
    return {"tokens": _meta((b, s), i64), "targets": _meta((b, s), i64)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict:
    """(cache, tokens / embeds, pos) of one decode step with a
    ``seq_len``-deep cache; ``pos`` a scalar, as the reference's."""
    b = shape.global_batch
    out = {"cache": cache_structs(cfg, b, shape.seq_len),
           "pos": _meta((), torch.int64)}
    if cfg.frontend == "frames":
        out["embeds"] = _meta((b, 1, cfg.d_model), DTYPES[cfg.compute_dtype])
    else:
        out["tokens"] = _meta((b, 1), torch.int64)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict:
    if shape.kind in ("train", "prefill"):
        return train_batch_specs(cfg, shape)
    return decode_input_specs(cfg, shape)

"""Weight bridge: the JAX package's parameters into the port's tensors.

``params_from_numpy`` takes the reference's parameter tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX
side) and returns the same tree of torch tensors on ``device``, keeping
every path name, so both packages compute on the same weights.  Nothing
here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree: Any,
                      device: torch.device | str | None = None) -> Any:
    """Nested dict of numpy arrays -> the same nested dict of tensors
    (copies; the arrays are left as they were) on ``device``, ``cuda``
    unless named (``NoCudaDevice`` without a card)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)

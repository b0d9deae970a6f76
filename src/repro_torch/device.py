"""Where the port's entry points run."""
from __future__ import annotations

import torch


class NoCudaDevice(RuntimeError):
    """An entry point was asked to run on the card and there is none."""


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises ``NoCudaDevice`` when CUDA is asked for (or implied)
    and unavailable — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev

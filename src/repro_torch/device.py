"""Where the port's entry points run."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a card, asking for the default raises — the port never
    drops to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)

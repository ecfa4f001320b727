"""Where an entry point runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device, who: str) -> torch.device:
    """torch.device(device); raises for a CUDA device where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (pass device='cpu' to run on the CPU)")
    return device

"""Device resolution for the port's entry points.

The port runs on the card unless the caller asks for the CPU. There is no
silent fallback: asking for CUDA on a machine without a usable card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev

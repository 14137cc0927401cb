"""The explicit device every entry point of the port takes."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; raises for CUDA when no GPU is visible (there
    is no silent CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; pass device='cpu' to run on the CPU"
        )
    return device

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


def resolve_devices(devices=None) -> list[torch.device]:
    """The devices a sharded index lays its shards on, one shard each (a
    device may repeat).  None means every visible CUDA device, the
    counterpart of the JAX package's `local_mesh()`; it raises when no GPU
    is visible."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "devices=None means every visible CUDA device, but torch.cuda.is_available() is False; "
                "pass devices=['cpu', ...] to run on the CPU"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        raise TypeError(f"devices must be a sequence of devices, got {devices!r}")
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("devices is empty")
    return out

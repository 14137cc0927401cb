"""Facts about the card a run uses.  A run that finds no card fails: there is
no CPU fallback for a measurement."""

from __future__ import annotations

import subprocess


class NoCard(RuntimeError):
    pass


def require_cuda(count: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: the benchmark runs only on a CUDA card")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} card(s), torch sees {torch.cuda.device_count()}")


def power_limit_w() -> float | None:
    """The card's power limit from nvidia-smi, or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device, count: int = 1) -> dict:
    """The result line's `device` object (without the trace's busy/window)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": count,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
        "power_limit_w": power_limit_w(),
    }

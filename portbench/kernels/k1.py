"""Kernel K1: the packed-layout attention `flash_attention_packed`
(`ops/flash.py` → `csrc/flash_packed.cu`).

`bound_s` is the least time one call could take on the card: q, k, v read
and o written once over the HBM rate, against the multiply-adds of
softmax(q·kᵀ)·v over the peak of the dtype's units (tensor cores for bf16,
the f32 units for the scalar f32 kernel).  A causal call needs only the
products on or below the diagonal.  The byte and operation counts are
copied from `chip_smoke.py::attention_bound_ms`, with the causal halving
and the f32 peak added."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import peaks  # noqa: E402

NAME = "K1"
# device kernel names of every route of csrc/flash_packed.cu's packed entry
PATTERN = r"\bflash_(bf16|wgmma|f32)_kernel"
WRAP = ("clip_retrieval_tpu_torch.ops.flash", "flash_attention_packed")


def shape_of(args, kwargs) -> tuple:
    """(B, S, heads, dh, causal, itemsize) of one call `f(q, k, v, heads, causal=)`."""
    q, heads = args[0], args[3]
    b, s, w = q.shape
    return (b, s, heads, w // heads, bool(kwargs.get("causal", False)), q.element_size())


def operations(b: int, s: int, heads: int, dh: int, causal: bool) -> float:
    pairs = s * (s + 1) / 2 if causal else s * s
    return 4.0 * b * heads * pairs * dh


def bytes_moved(b: int, s: int, heads: int, dh: int, itemsize: int) -> float:
    return 4.0 * b * heads * s * dh * itemsize


def bound_s(shape: tuple) -> float:
    b, s, heads, dh, causal, itemsize = shape
    peak = peaks.BF16_FLOPS if itemsize == 2 else peaks.F32_FLOPS
    return max(bytes_moved(b, s, heads, dh, itemsize) / peaks.HBM_BYTES_PER_S,
               operations(b, s, heads, dh, causal) / peak)

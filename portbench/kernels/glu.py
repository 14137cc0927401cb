"""The SwiGLU gate with its LayerNorm of EVA02's MLP, `glu_layernorm`
(`ops/block_fused.py` → `csrc/block_fused.cu`, entry `crt_glu_layernorm`).

`bound_s` is the least time one call could take on the card: the bytes it
must move over the HBM rate (a few tens of operations an element, far below
the tensor cores' line), counted at the model's hidden h, whatever the
program pads: g and x read once from the f32 accumulator (8 bytes a hidden
element), the hidden written once in its dtype, the biases and the
LayerNorm's affine read once."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import peaks  # noqa: E402

NAME = "glu"
PATTERN = r"\bglu_layernorm_kernel"
WRAP = ("clip_retrieval_tpu_torch.ops.block_fused", "glu_layernorm")


def shape_of(args, kwargs) -> tuple:
    """(rows, hidden h, has bias, output itemsize) of one call
    `f(acc, bias, scale, ln_bias, eps, dtype=)`."""
    import torch

    acc, bias, scale = args[0], args[1], args[2]
    return (acc.numel() // acc.shape[-1], scale.shape[0], bias is not None,
            torch.empty((), dtype=kwargs["dtype"]).element_size())


def bytes_moved(rows: int, h: int, has_bias: bool, itemsize: int) -> float:
    return rows * h * (8.0 + itemsize) + (8.0 * h if has_bias else 0.0) + 8.0 * h


def bound_s(shape: tuple) -> float:
    return bytes_moved(*shape) / peaks.HBM_BYTES_PER_S

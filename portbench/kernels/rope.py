"""The rotary epilogue of EVA02's q and k products, `rope_epilogue`
(`ops/block_fused.py` → `csrc/block_fused.cu`, entry `crt_rope`).

`bound_s` is the least time one call could take on the card: the bytes it
must move over the HBM rate (a few operations an element, far below the
tensor cores' line): the f32 accumulator read once, the bias and the
cos/sin table once, the output written once in its dtype."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import peaks  # noqa: E402

NAME = "rope"
PATTERN = r"\brope_epilogue_kernel"
WRAP = ("clip_retrieval_tpu_torch.ops.block_fused", "rope_epilogue")


def shape_of(args, kwargs) -> tuple:
    """(rows, width, rotated rows of the table, head dim, has bias, output
    itemsize) of one call `f(acc, bias, table, prefix=, dtype=)`."""
    import torch

    acc, bias, table = args[0], args[1], args[2]
    b, s, w = acc.shape
    return (b * s, w, table.shape[1], 2 * table.shape[2], bias is not None,
            torch.empty((), dtype=kwargs["dtype"]).element_size())


def bytes_moved(rows: int, w: int, table_rows: int, dh: int, has_bias: bool, itemsize: int) -> float:
    return rows * w * (4.0 + itemsize) + (4.0 * w if has_bias else 0.0) + 4.0 * table_rows * dh


def bound_s(shape: tuple) -> float:
    return bytes_moved(*shape) / peaks.HBM_BYTES_PER_S

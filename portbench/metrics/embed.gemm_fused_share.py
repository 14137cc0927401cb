"""The share of the towers' dense calls that ran as the one-kernel GEMM
with its epilogue, in %: Σ `gemm` ÷ Σ (`gemm` + `split`) over the program's
`mapper.image` and `mapper.text` spans of the window's batches.  `gemm`
counts the launches of `ops/block_fused.py::dense_gemm` while a tower was
queued, `split` the denses that took the f32 product and the epilogue's
pass (`dense_epilogue`) instead.  None for a program without the counters,
or when neither counted a call."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    found = (spans.of(ctx, "mapper.image") or []) + (spans.of(ctx, "mapper.text") or [])
    found = [s for s in found if "gemm" in s["counters"]]
    if not found:
        return None
    gemm = spans.counter(found, "gemm")
    total = gemm + spans.counter(found, "split")
    return 100.0 * gemm / total if total > 0 else None

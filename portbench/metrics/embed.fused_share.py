"""The share of the towers' dense and LayerNorm passes that ran as the
block's fused kernels, in %: Σ `fused` ÷ Σ (`fused` + `eager`) over the
program's `mapper.image` and `mapper.text` spans of the window's batches.
`fused` counts the kernel launches of `ops/block_fused.py` while a tower was
queued, `eager` the dense and LayerNorm calls that took the eager chain.
None for a program without the counters, or when neither counted a call."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    found = (spans.of(ctx, "mapper.image") or []) + (spans.of(ctx, "mapper.text") or [])
    found = [s for s in found if "fused" in s["counters"]]
    if not found:
        return None
    fused = spans.counter(found, "fused")
    total = fused + spans.counter(found, "eager")
    return 100.0 * fused / total if total > 0 else None

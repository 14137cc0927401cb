"""Image-tower tokens embedded per second of the window: Σ the `tokens`
counter (rows × the tower's sequence length) of the program's
`mapper.image` spans over the window's batches ÷ the window's seconds.  A
rate in a unit that carries across image sizes and models.  None for a
program without the span."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    found = spans.of(ctx, "mapper.image")
    w = ctx["run"]["window_s"]
    if not found or w <= 0:
        return None
    return spans.counter(found, "tokens") / w

"""The SwiGLU gate's share of its roofline over the embedding window, in %:
the summed least time of every recorded launch (`kernels/glu.py`) over its
device time in the trace.  None for a program without the kernel."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import readers  # noqa: E402


def read(ctx):
    return readers.roofline(ctx, "glu")

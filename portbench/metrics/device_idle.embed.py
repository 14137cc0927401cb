"""Share of the traced embedding window with nothing running on the
device (kernels, copies and sets, as a union of intervals), in %."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import readers  # noqa: E402


def read(ctx):
    return readers.idle_share(ctx)

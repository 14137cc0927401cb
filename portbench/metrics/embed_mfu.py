"""Model FLOPs of the samples embedded (both towers, counted from the
configuration's shapes by `bench/flops.py`) over the window, as a share of
the card's dense bf16 peak, in %."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import readers  # noqa: E402


def read(ctx):
    run = ctx["run"]
    return readers.mfu(run["samples"] * run["flops_per_sample"], run["window_s"])

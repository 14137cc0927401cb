"""Share of the window the runner's thread waited for the next staged
batch (the program's `staging.take` spans over the window's batches), in %:
the reader and staging layer holding the mapper back, measured inside the
program."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    return spans.window_share(ctx, "staging.take")

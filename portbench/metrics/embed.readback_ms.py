"""Mean ms per window batch of the mapper reading its embeddings back to
the host (the program's `mapper.readback` span: the wait for the device to
finish the queued towers, and the copies)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    return spans.mean_ms(ctx, "mapper.readback")

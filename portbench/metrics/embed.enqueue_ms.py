"""Mean ms per window batch of the mapper queuing both towers on the
device (the program's `mapper.enqueue` span: the call's Python and kernel
launches, up to its first read-back)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    return spans.mean_ms(ctx, "mapper.enqueue")

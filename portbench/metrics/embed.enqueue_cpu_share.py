"""The mapper thread's CPU time over its wall time while it queued the
towers (the `cpu_ns` counter of the program's `mapper.enqueue` spans over
their durations, window batches), in %: below 100, the launch thread waited
for the interpreter lock or for a core."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    found = spans.of(ctx, "mapper.enqueue")
    if not found:
        return None
    wall = spans.seconds(found)
    return 100.0 * spans.counter(found, "cpu_ns") * 1e-9 / wall if wall > 0 else None

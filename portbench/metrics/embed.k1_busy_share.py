"""Kernel K1's share of the device's busy time over the traced embedding
window, in %: K1's device seconds (the launches matching
`kernels/k1.py`'s PATTERN) over the union of kernel, copy and set
intervals.  How much of the device the towers' attention takes."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spec  # noqa: E402


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    busy = trace.busy_s()
    seconds, launches = trace.kernel_seconds(spec.kernel("k1").PATTERN)
    return 100.0 * seconds / busy if busy > 0 and launches else None

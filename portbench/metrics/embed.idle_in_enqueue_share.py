"""Share of the traced window the device sat idle while the mapper was
still queuing the towers (device-idle time inside the program's
`mapper.enqueue` spans ÷ the window), in %, in the units of
`device_idle.embed`: the part of the idle that waits on the launch thread.
None when the spans and the trace's launch calls do not line up."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    return spans.idle_inside(ctx, "mapper.enqueue")

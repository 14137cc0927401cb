"""How busy the reader's decode pool was: Σ wall time of its per-sample
loads (read, decode, resize, tokenize) for the window's batches, over the
pool's workers × the window, in % (the decode counters the program carries
on each batch's `staging.stage` span)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import spans  # noqa: E402


def read(ctx):
    found = spans.of(ctx, "staging.stage")
    workers = max((s["counters"].get("decode_workers", 0) for s in found or ()), default=0)
    w = ctx["run"]["window_s"]
    if not workers or w <= 0:
        return None
    return 100.0 * spans.counter(found, "decode_wall_ns") * 1e-9 / (workers * w)

"""The program's own spans over the window, for the per-layer metrics that
read them.

The program records its embedding loop's spans and counters in memory
(`clip_retrieval_tpu_torch/utils/trace.py`, exported in unix ns).  The
window's batches are the last `ctx["run"]["batches"]` `runner.batch` spans
of the last runner call (`runner.partition`); every span that carries one of
their batch numbers belongs to the window, whichever thread recorded it.
A program without the recorder, or a window the recorder's ring no longer
holds whole, gives None.
"""

from __future__ import annotations

import sys

# Kineto's trace base: unix time floored to this period, so that a Chrome
# trace's `ts` (µs) + `baseTimeNanoseconds` is unix ns
TRIMONTH_S = 7_889_238
ALIGNED = 0.99  # least share of the trace's launch calls inside `mapper.enqueue` spans


def _spans(ctx: dict) -> list[dict] | None:
    if "spans" not in ctx:
        try:
            from clip_retrieval_tpu_torch.utils import trace
        except ImportError:  # a program without the recorder
            ctx["spans"] = None
        else:
            ctx["spans"] = trace.export()
    return ctx["spans"]


def window(ctx: dict) -> dict[int, dict[str, list[dict]]] | None:
    """{batch number: {span name: [spans]}} for the window's batches."""
    spans, n = _spans(ctx), ctx["run"]["batches"]
    parts = [s for s in spans or () if s["name"] == "runner.partition"]
    if not parts or n <= 0:
        return None
    roots = [s for s in spans if s["name"] == "runner.batch" and s["parent"] == parts[-1]["id"]][-n:]
    if len(roots) < n:
        return None
    out: dict[int, dict[str, list[dict]]] = {r["batch"]: {} for r in roots}
    for s in spans:
        if s["batch"] in out and s["name"] != "runner.partition":
            out[s["batch"]].setdefault(s["name"], []).append(s)
    return out


def of(ctx: dict, name: str) -> list[dict] | None:
    """The window's spans named `name`, or None."""
    win = window(ctx)
    if win is None:
        return None
    found = [s for batch in win.values() for s in batch.get(name, ())]
    return found or None


def seconds(spans: list[dict]) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e9


def counter(spans: list[dict], key: str) -> int:
    return sum(s["counters"].get(key, 0) for s in spans)


def mean_ms(ctx: dict, name: str) -> float | None:
    """Mean ms of the span `name` per window batch."""
    found = of(ctx, name)
    return 1e3 * seconds(found) / ctx["run"]["batches"] if found else None


def window_share(ctx: dict, name: str) -> float | None:
    """Σ the span `name` over the window's batches ÷ the window, in %."""
    found = of(ctx, name)
    w = ctx["run"]["window_s"]
    return 100.0 * seconds(found) / w if found and w > 0 else None


def _merged(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(points: list[float], intervals: list[list[float]]) -> int:
    """How many of the sorted `points` fall in one of the sorted, disjoint `intervals`."""
    n, i = 0, 0
    for p in points:
        while i < len(intervals) and intervals[i][1] < p:
            i += 1
        if i < len(intervals) and intervals[i][0] <= p:
            n += 1
    return n


def _overlap(a: list[list[float]], b: list[list[float]]) -> float:
    """Σ length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(ctx: dict, name: str) -> float | None:
    """Device-idle time inside the window's spans `name` ÷ the traced
    window, in %.  The spans are put on the trace's µs by Kineto's base rule;
    None without a trace, or when fewer than ALIGNED of the trace's host
    launch calls start inside them (the clocks disagree)."""
    trace, found = ctx.get("trace"), of(ctx, name)
    if trace is None or not found or trace.window_s <= 0:
        return None
    last_s = max(s["end_ns"] for s in found) // 10**9
    base_ns = last_s // TRIMONTH_S * TRIMONTH_S * 10**9
    spans = _merged(((s["start_ns"] - base_ns) / 1e3, (s["end_ns"] - base_ns) / 1e3) for s in found)
    launches = sorted(s for s, _, n in trace.runtime if "LaunchKernel" in n)
    inside = _inside(launches, spans)
    if not launches or inside < ALIGNED * len(launches):
        print(f"{name}: {inside} of {len(launches)} launch calls inside its spans; the clocks disagree, "
              "no idle share", file=sys.stderr)
        return None
    busy = _merged((s, e) for s, e, _ in trace.ops)
    idle_us = sum(e - s for s, e in spans) - _overlap(spans, busy)
    return 100.0 * idle_us * 1e-6 / trace.window_s

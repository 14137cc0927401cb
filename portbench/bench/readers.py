"""Helpers the per-layer metric readers share.  A reader returns None when
the run holds nothing for it to read; the harness then leaves the metric
out of the line."""

from __future__ import annotations

import sys

from . import peaks


def roofline(ctx: dict, kernel: str) -> float | None:
    """Σ least time of the kernel's recorded launches ÷ its device time in
    the trace, in %.  None without a trace, without launches, or when the
    trace and the launch records disagree on the count."""
    trace, rec = ctx.get("trace"), ctx.get("kernels", {}).get(kernel)
    if trace is None or rec is None or not rec.shapes:
        return None
    seconds, launches = trace.kernel_seconds(rec.k.PATTERN)
    if launches != len(rec.shapes) or seconds <= 0:
        print(f"{kernel}: {launches} launches in the trace, {len(rec.shapes)} recorded; no roofline",
              file=sys.stderr)
        return None
    return 100.0 * rec.bound_s() / seconds


def idle_share(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (trace.window_s - trace.busy_s()) / trace.window_s


def mfu(flop: float, seconds: float) -> float | None:
    if seconds <= 0 or flop <= 0:
        return None
    return 100.0 * flop / seconds / peaks.BF16_FLOPS

"""Pauses of Python's cyclic garbage collector during a window, from
`gc.callbacks`: every collection stops every thread of the process, and
the service's request threads feel it in their latency."""

from __future__ import annotations

import gc
import time


class GcWatch:
    def __init__(self):
        self.pauses: list[tuple[int, float]] = []  # (generation, seconds)
        self._t0 = 0.0

    def _cb(self, phase: str, info: dict):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._t0))

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        full = [s for g, s in self.pauses if g == 2]
        return {"gc_collections": len(self.pauses), "gc_full": len(full),
                "gc_full_ms_total": 1e3 * sum(full), "gc_max_ms": 1e3 * max((s for _, s in self.pauses), default=0.0)}

"""The traced window of a `--trace 1` run: `torch.profiler` with CUDA activity
only (recording every CPU operator would slow the host side the run
measures), exported as a Chrome trace and reduced to device intervals.

- busy: the union of kernel, memcpy and memset intervals;
- a kernel's time: the sum of the durations of its launches, matched by a
  regular expression over the kernel name (the kernel modules under
  `portbench/kernels/` hold the patterns);
- idle gaps: the longest stretches with nothing on the device, each named
  by the host's CUDA runtime call in flight when it ended and the device
  operation that ended it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    ops: list[tuple[float, float, str]]  # (start us, end us, name), device operations
    runtime: list[tuple[float, float, str]]  # (start us, end us, name), host CUDA runtime calls

    def busy_s(self) -> float:
        total, cur_s, cur_e = 0.0, None, None
        for s, e, _ in sorted(self.ops):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """(summed seconds, launches) of the device operations matching `pattern`."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, n in self.ops if rx.search(n)]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for s, e, name in self.ops:
            key = _short(name)
            by[key] = by.get(key, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        ops = sorted(self.ops)
        rt = sorted(self.runtime)
        gaps = []
        end = None
        for s, e, name in ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s, name))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for dur, g0, g1, nxt in gaps[:n]:
            host = [r for r in rt if r[0] <= g1 and r[1] >= g0]
            label = host[-1][2] if host else "no CUDA runtime call"
            out.append([f"host in {label}; then {_short(nxt)}", dur * 1e-6])
        return out


def _short(name: str) -> str:
    """Kernel names without template arguments and parameter lists."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    for sep in ("(", "<"):
        i = name.find(sep)
        if i > 0:
            name = name[:i]
    return name[:120]


class Profiler:
    """Start/stop around a window; `result()` parses the exported trace."""

    def __init__(self, out_dir: str):
        import torch

        self.out_dir = out_dir
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0.0

    def start(self):
        import torch

        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def result(self) -> DeviceTrace:
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        ops, runtime = [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                ops.append((s, e, ev.get("name", "?")))
            elif cat == "cuda_runtime" or cat == "cuda_driver":
                runtime.append((s, e, ev.get("name", "?")))
        return DeviceTrace(self.t1 - self.t0, ops, runtime)

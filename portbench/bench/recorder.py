"""Launch records of the program's kernels during a traced window.

In a `--trace 1` run the harness wraps each kernel module's entry point
(`portbench/kernels/<k>.py`: `WRAP` names the program's module and
attribute) with a function that notes the call's shape and calls through.
The shapes give each launch's least time; the profiler gives the kernels'
device time.  Untraced runs install nothing."""

from __future__ import annotations

import functools
import importlib
import threading


class KernelRecorder:
    def __init__(self, kernel_mod):
        self.k = kernel_mod
        self.shapes: list[tuple] = []
        self.active = False
        self._lock = threading.Lock()
        mod_name, attr = kernel_mod.WRAP
        self._mod = importlib.import_module(mod_name)
        self._attr = attr
        self._orig = getattr(self._mod, attr)
        orig = self._orig

        def wrapped(*args, **kwargs):
            if self.active:
                shape = kernel_mod.shape_of(args, kwargs)
                with self._lock:
                    self.shapes.append(shape)
            return orig(*args, **kwargs)

        # the wrapper carries the entry's attributes (its launch counter, which
        # the entry increments through its module-level name) and hands them back
        self._wrapped = functools.update_wrapper(wrapped, orig)
        setattr(self._mod, attr, wrapped)

    def bound_s(self) -> float:
        return sum(self.k.bound_s(s) for s in self.shapes)

    def restore(self):
        self._orig.__dict__.update({k: v for k, v in self._wrapped.__dict__.items() if k != "__wrapped__"})
        setattr(self._mod, self._attr, self._orig)

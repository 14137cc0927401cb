"""Vector indices on torch: flat, int8 flat, IVF-int8 (on kernel K3), IVF-PQ
(on kernel K4), re-ranking, index loading and the `clip_index` build.
Modules are imported on use: the names below resolve lazily, so importing
this package does not load the index stack."""

import importlib

_EXPORTS = {"FlatIndex": "flat", "IVFPQIndex": "ivfpq", "load_index": "store", "calibrate_nprobe": "build",
            "clip_index": "build", "score_index": "build"}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

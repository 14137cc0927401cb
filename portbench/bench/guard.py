"""What a run may and may not have loaded.

The program under test is `clip_retrieval_tpu_torch`; its JAX original,
`clip_retrieval_tpu`, and JAX itself must never be loaded by a run.  Names
are compared by their whole top-level part (before the first dot), since
the port's name begins with the original's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "clip_retrieval_tpu")
PROGRAM = "clip_retrieval_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """Names in `modules` (default: sys.modules) whose top level is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)

"""Minimal brace expansion for webdataset shard patterns.

Copy of `clip_retrieval_tpu/utils/braces.py`.  The reference depends on the
`braceexpand` package (its `clip_retrieval/clip_inference/main.py:5,105`);
this is a dependency-free equivalent covering the patterns that matter for shards:
`{0000..0123}` numeric ranges (zero-padding preserved) and `{a,b,c}` lists,
including nesting.
"""

from __future__ import annotations

import re
from typing import List

_RANGE = re.compile(r"^(\d+)\.\.(\d+)$")


def _expand_inner(spec: str) -> List[str]:
    m = _RANGE.match(spec)
    if m:
        a, b = m.group(1), m.group(2)
        width = len(a) if len(a) == len(b) and a.startswith("0") else 0
        lo, hi = int(a), int(b)
        step = 1 if hi >= lo else -1
        return [
            str(i).zfill(width) if width else str(i)
            for i in range(lo, hi + step, step)
        ]
    # comma list (top-level commas only)
    parts, depth, cur = [], 0, ""
    for ch in spec:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    if len(parts) == 1:
        return ["{" + spec + "}"]  # not a brace expression; keep literal
    out: List[str] = []
    for p in parts:
        out.extend(braceexpand(p))
    return out


def braceexpand(pattern: str) -> List[str]:
    """Expand the first balanced {...} group, then recurse."""
    depth = 0
    start = -1
    for i, ch in enumerate(pattern):
        if ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                head, spec, tail = (
                    pattern[:start],
                    pattern[start + 1 : i],
                    pattern[i + 1 :],
                )
                return [
                    head + mid + rest
                    for mid in _expand_inner(spec)
                    for rest in braceexpand(tail)
                ]
    return [pattern]

"""CPU test of `embed.fused_share`, read from the program's `mapper.image`
and `mapper.text` spans (`fused` and `eager` counters): 100 when every
dense and LayerNorm of the towers ran as a fused kernel, None for a program
without the counters.

Run from the root of a checkout: `python -m pytest portbench/tests -q`."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import spec  # noqa: E402

T0 = 1_792_304_783 * 10**9  # unix ns of the synthetic window's start


def _tower_spans(counters: dict | None) -> dict:
    """Two window batches, each with a `mapper.image` and a `mapper.text`
    span carrying `counters` besides `tokens` (none when None)."""
    out = [{"name": "runner.partition", "id": 1, "parent": None, "batch": None, "start_ns": T0,
            "end_ns": T0 + 10**9, "counters": {}}]
    for b in range(2):
        out.append({"name": "runner.batch", "id": 10 + b, "parent": 1, "batch": b + 1, "start_ns": T0,
                    "end_ns": T0 + 1, "counters": {"samples": 4}})
        for k, tower in enumerate(("mapper.image", "mapper.text")):
            out.append({"name": tower, "id": 20 + 2 * b + k, "parent": 10 + b, "batch": b + 1, "start_ns": T0,
                        "end_ns": T0 + 1, "counters": {"tokens": 8, **(counters or {})}})
    return {"run": {"batches": 2, "window_s": 1.0}, "spans": out, "trace": None}


@pytest.mark.parametrize("counters,want", [({"fused": 218, "eager": 0}, 100.0), ({"fused": 3, "eager": 1}, 75.0)])
def test_fused_share_reads_the_tower_counters(counters, want):
    assert spec.metric_reader("embed.fused_share").read(_tower_spans(counters)) == pytest.approx(want)


@pytest.mark.parametrize("ctx", [
    _tower_spans(None),  # a program without the counters
    _tower_spans({"fused": 0, "eager": 0}),  # no dense or LayerNorm counted
    {"run": {"batches": 2, "window_s": 1.0}, "spans": None, "trace": None},  # no recorder
])
def test_fused_share_is_none_without_counts(ctx):
    assert spec.metric_reader("embed.fused_share").read(ctx) is None

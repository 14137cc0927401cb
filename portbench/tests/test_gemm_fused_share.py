"""CPU test of `embed.gemm_fused_share`, read from the program's
`mapper.image` and `mapper.text` spans (`gemm` and `split` counters): 100
when every dense of the towers ran as the one-kernel GEMM, None for a
program without the counters.

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
    span carrying `counters` besides `tokens` and `fused` (none when None)."""
    out = [{"name": "runner.partition", "id": 1, "parent": None, "batch": None, "start_ns": T0,
            "end_ns": T0 + 10**9, "counters": {}}]
    for b in range(2):
        out.append({"name": "runner.batch", "id": 10 + b, "parent": 1, "batch": b + 1, "start_ns": T0,
                    "end_ns": T0 + 1, "counters": {"samples": 4}})
        for k, tower in enumerate(("mapper.image", "mapper.text")):
            out.append({"name": tower, "id": 20 + 2 * b + k, "parent": 10 + b, "batch": b + 1, "start_ns": T0,
                        "end_ns": T0 + 1, "counters": {"tokens": 8, "fused": 200, "eager": 0, **(counters or {})}})
    return {"run": {"batches": 2, "window_s": 1.0}, "spans": out, "trace": None}


@pytest.mark.parametrize("counters,want", [
    ({"gemm": 165, "split": 0}, 100.0),
    ({"gemm": 3, "split": 1}, 75.0),
    ({"gemm": 0, "split": 162}, 0.0),  # the parent's split route, had it the counters
])
def test_gemm_fused_share_reads_the_tower_counters(counters, want):
    assert spec.metric_reader("embed.gemm_fused_share").read(_tower_spans(counters)) == pytest.approx(want)


def test_gemm_fused_share_sums_over_both_towers():
    ctx = _tower_spans({"gemm": 1, "split": 0})
    for s in ctx["spans"]:
        if s["name"] == "mapper.text":
            s["counters"].update(gemm=0, split=1)
    assert spec.metric_reader("embed.gemm_fused_share").read(ctx) == pytest.approx(50.0)


@pytest.mark.parametrize("ctx", [
    _tower_spans(None),  # a program without the counters (fused and eager only)
    _tower_spans({"gemm": 0, "split": 0}),  # no dense counted
    {"run": {"batches": 2, "window_s": 1.0}, "spans": None, "trace": None},  # no recorder
])
def test_gemm_fused_share_is_none_without_counts(ctx):
    assert spec.metric_reader("embed.gemm_fused_share").read(ctx) is None

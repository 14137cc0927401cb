"""CPU tests of the per-layer metrics read from the program's own spans
(`bench/spans.py`): a traced rehearsal of the embedding cell carries them,
and the idle share inside `mapper.enqueue` spans reads a synthetic device
trace only when its launch calls line up with the spans.

Run from the root of a checkout: `python -m pytest portbench/tests -q`."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PB))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench import spans, spec  # noqa: E402
from bench.trace import DeviceTrace  # noqa: E402
from test_portbench_harness import TINY, _execute, _tiny  # noqa: E402

CELL = "embed.vit-l-14.jpeg"
PROGRAM_METRICS = ["embed.stage_wait_share", "embed.enqueue_ms", "embed.readback_ms", "embed.enqueue_cpu_share",
                   "embed.decode_busy_share"]


def test_traced_rehearsal_carries_the_program_metrics(tmp_path):
    cell = _tiny(CELL, *TINY[CELL])
    result, checks = _execute(cell, tmp_path, trace=True)
    assert result["correct"] is True, checks
    got = {name: m["value"] for name, m in result["metrics"].items()}
    for name in PROGRAM_METRICS:
        assert isinstance(got.get(name), float) and got[name] >= 0, name
    assert got["embed.enqueue_ms"] + got["embed.readback_ms"] <= got["embed.mapper_ms"]
    assert got["embed.stage_wait_share"] <= got["embed.read_wait_share"]
    assert 0 < got["embed.decode_busy_share"] <= 100
    assert "embed.idle_in_enqueue_share" not in got  # no device trace on the CPU


def test_every_program_metric_reads_none_without_the_recorder():
    """A program without the recorder (the parent of this metric set) leaves
    the metrics out of the line instead of failing the run."""
    ctx = {"run": {"batches": 3, "window_s": 1.0}, "trace": None, "spans": None}
    for name in PROGRAM_METRICS + ["embed.idle_in_enqueue_share"]:
        assert spec.metric_reader(name).read(ctx) is None, name


T0 = 1_792_304_783 * 10**9  # unix ns of the synthetic window's start


def _synthetic(shift_ms: float = 0.0):
    """Three batches of 100 ms: enqueue 0–60 ms, readback 60–90 ms.  The
    device runs 10–50 ms and 60–85 ms of each, so 10 ms of each enqueue is
    idle; ten launch calls fall inside each enqueue (shifted by `shift_ms`)."""
    base_ns = T0 // 10**9 // spans.TRIMONTH_S * spans.TRIMONTH_S * 10**9
    ms = 10**6
    out = [{"name": "runner.partition", "id": 1, "parent": None, "batch": None, "start_ns": T0,
            "end_ns": T0 + 300 * ms, "counters": {}}]
    ops, runtime = [], []
    for b in range(3):
        t = T0 + 100 * ms * b
        out += [
            {"name": "runner.batch", "id": 10 + b, "parent": 1, "batch": b + 1, "start_ns": t,
             "end_ns": t + 100 * ms, "counters": {"samples": 4}},
            {"name": "mapper.enqueue", "id": 20 + b, "parent": 10 + b, "batch": b + 1, "start_ns": t,
             "end_ns": t + 60 * ms, "counters": {"cpu_ns": 30 * ms}},
        ]
        us = (t - base_ns) / 1e3
        ops += [(us + 10e3, us + 50e3, "kernel"), (us + 60e3, us + 85e3, "kernel")]
        runtime += [(us + (5 + 5 * k + shift_ms) * 1e3, us + (5.01 + 5 * k + shift_ms) * 1e3, "cudaLaunchKernel")
                    for k in range(10)]
    return {"run": {"batches": 3, "window_s": 0.3}, "spans": out,
            "trace": DeviceTrace(window_s=0.3, ops=ops, runtime=runtime)}


def test_idle_inside_enqueue_on_a_synthetic_trace():
    ctx = _synthetic()
    # 3 × (60 − 40) ms idle inside the enqueue spans, over a 300 ms window
    assert spans.idle_inside(ctx, "mapper.enqueue") == pytest.approx(20.0)
    assert spec.metric_reader("embed.idle_in_enqueue_share").read(ctx) == pytest.approx(20.0)
    assert spec.metric_reader("embed.enqueue_cpu_share").read(ctx) == pytest.approx(50.0)
    assert spec.metric_reader("embed.enqueue_ms").read(ctx) == pytest.approx(60.0)


def test_launch_calls_shifted_off_the_spans_give_none(capsys):
    assert spans.idle_inside(_synthetic(shift_ms=50.0), "mapper.enqueue") is None
    assert "clocks disagree" in capsys.readouterr().err

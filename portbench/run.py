#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix, driver
and limits are found by name (`bench/spec.py`).  Set-up (inputs and weights
made from the seed, the program built and warmed) is timed as `setup_s`, up
to where the cell's driver (`portbench/drivers/<kind>.py`) opens its window,
which lasts `--seconds`; then the program's state is freed and its outputs
are held to the plain reference.  With `--trace 0` the line carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, read from a
`torch.profiler` trace of the window and from the program's counters and
spans.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` when traced),
and last `checks`, each number compared with its limit; the same checks are
the last lines of standard error.  No card, too few cards, the program
missing from the checkout, or JAX loaded in this process: a message on
standard error, no result line, and a non-zero exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# every build and kernel cache of the program lives at a fixed path inside the checkout: the
# program's nvcc builds go to build/torch_kernels/<hash>/ by themselves (ops/cuda_build.py);
# a Triton kernel or torch extension would use these
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(CHECKOUT))

from bench import device as dev  # noqa: E402
from bench import guard, spec  # noqa: E402

PROGRAM = guard.PROGRAM


class Refused(RuntimeError):
    """A run that must print no result."""


def program_in_checkout() -> None:
    found = importlib.util.find_spec(PROGRAM)
    origin = Path(found.origin).resolve() if found is not None and found.origin else None
    if origin is None or CHECKOUT not in origin.parents:
        raise Refused(f"{PROGRAM} is not in this checkout ({CHECKOUT}); found {origin}")


def _kernels_of(cell) -> list[str]:
    """Kernels whose roofline the cell reports: `k1_roofline.embed` → k1."""
    return sorted({m["name"].split("_roofline", 1)[0] for m in cell.per_layer if "_roofline" in m["name"]})


def host_probe_ms() -> float:
    """ms of a fixed pure-Python loop: how much of a core this process got,
    a reading of the host's contention beside each run's numbers."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i & 7
    return 1e3 * (time.perf_counter() - t0)


def execute(cell, seed: int, seconds: float, trace: bool, device, workdir: str, controls: tuple = ()):
    """One run of `cell`: returns (result object, checks).  Each of
    `controls` (keyword arguments of the cell driver's check that put the
    reference, computed in a lower precision, in the program's place) is
    checked after the run's own check, under the result's `controls`."""
    import torch

    from bench.gcwatch import GcWatch
    from bench.recorder import KernelRecorder
    from bench.trace import Profiler

    drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, device, workdir)
    probe = host_probe_ms()
    drv.setup()
    recorders = {k: KernelRecorder(spec.kernel(k)) for k in _kernels_of(cell)} if trace else {}
    prof = Profiler(os.path.join(workdir, "trace")) if trace and device.type == "cuda" else None
    marks = {}

    def window_opens():
        """Set-up ends here; the window's peak, trace and launch records start."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks["setup_s"] = time.perf_counter() - T_START
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if prof is not None:
            prof.start()
        for r in recorders.values():
            r.active = True
        marks["rusage"] = resource.getrusage(resource.RUSAGE_SELF)

    def window_closes():
        marks["rusage_end"] = resource.getrusage(resource.RUSAGE_SELF)
        for r in recorders.values():
            r.active = False
        if prof is not None:
            prof.stop()

    with GcWatch() as gcw:
        drv.window(seconds, window_opens, window_closes)
    ru0, ru1 = marks["rusage"], marks["rusage_end"]
    setup_s = marks["setup_s"]
    dev_info = dev.describe(device)
    loaded = guard.forbidden_loaded()
    if loaded:
        raise Refused(f"forbidden modules loaded in this process: {loaded}")
    # how much of the host this process got in the window, beside the host's load
    notes = {**drv.notes, **gcw.summary(), "host_probe_ms": [probe, host_probe_ms()],
             "window_cpu_s": ru1.ru_utime + ru1.ru_stime - ru0.ru_utime - ru0.ru_stime,
             "window_involuntary_switches": ru1.ru_nivcsw - ru0.ru_nivcsw, "loadavg": os.getloadavg()}
    run_ctx = drv.context()
    e2e = drv.end_to_end()
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = _checks(cell, drv.check())
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    result = {"correct": bool(correct), "attempted": drv.attempted(), "failed": drv.failed(), "metrics": metrics,
              "device": dev_info}
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        tr = prof.result() if prof is not None else None
        ctx = {"run": run_ctx, "trace": tr, "kernels": recorders}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            dev_info["busy_s"] = tr.busy_s()
            dev_info["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
        for r in recorders.values():
            r.restore()
    if controls:
        notes["controls"] = [{"control": c, "checks": _checks(cell, drv.check(**c))} for c in controls]
    result["notes"] = notes
    result["checks"] = checks
    return result, checks


def _checks(cell, raw: dict) -> dict:
    return {name: {"value": value, "limit": cell.limits[name]["max"]} for name, value in raw.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workdir = None
    try:
        program_in_checkout()
        bench_spec = spec.benchmark()
        entry = next((w for w in bench_spec["workloads"] if w["name"] == args.workload), None)
        if entry is None:
            raise Refused(f"no workload {args.workload!r} in BENCHMARK.json")
        dev.require_cuda(entry["chips"])
        import torch

        cell = spec.resolve(args.workload)
        workdir = tempfile.mkdtemp(prefix="portbench-")
        result, checks = execute(cell, args.seed & (2**63 - 1), args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), workdir)
    except (Refused, dev.NoCard) as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    finally:
        if workdir is not None:
            shutil.rmtree(workdir, ignore_errors=True)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"refused: forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 3
    notes = result.pop("notes")
    print("notes " + json.dumps(notes), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

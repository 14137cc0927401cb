"""Resolve a cell of BENCHMARK.json to the files that define it.

Every piece is found by name, so a later cell or metric is added by adding
files and entries, never by editing one:

- a configuration: `portbench/configs/<config>.json`;
- a traffic mix: `portbench/traffic/<traffic>.json`, whose `driver` key
  names `portbench/drivers/<driver>.py`;
- the limits of the cell's correctness check: `portbench/limits/<cell>.json`;
- a per-layer metric: `portbench/metrics/<metric>.py`, a module with
  `read(ctx) -> float | None`;
- a kernel's operation and byte counts: `portbench/kernels/<kernel>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

PORTBENCH = Path(__file__).resolve().parents[1]
CHECKOUT = PORTBENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = CHECKOUT) -> Cell:
    """The cell named `workload`, with its files loaded; raises KeyError for
    an unknown name and FileNotFoundError for a missing file."""
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    base = root / "portbench"
    config = load_json(base / "configs" / f"{entry['config']}.json")
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(base / "limits" / f"{workload}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload) and m["moves"] in reported]
    return Cell(workload, config, traffic, limits, e2e, per_layer)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by path (metric file names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    return load_module(PORTBENCH / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def metric_reader(name: str) -> ModuleType:
    return load_module(PORTBENCH / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_"))


def kernel(name: str) -> ModuleType:
    return load_module(PORTBENCH / "kernels" / f"{name}.py", f"portbench_kernel_{name}")

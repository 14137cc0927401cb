"""CPU tests of the benchmark harness: the spec resolves, names keep to the
contract's characters, the kernel and FLOP counters match hand-worked
shapes, the embedding driver rehearses end to end at a tiny size and prints
a well-formed line, the control and planted faults come out not correct,
and nothing of the harness loads JAX or the JAX package.

Run from the root of a checkout: `python -m pytest portbench/tests -q`."""

from __future__ import annotations

import ast
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
sys.path.insert(0, str(PB))
sys.path.insert(1, str(ROOT))

from bench import flops, guard, spec  # noqa: E402

DATA = PB / "tests" / "data"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


# -- the spec ---------------------------------------------------------------


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (PB / "traffic" / f"{entry['traffic']}.json").exists()
    assert (PB / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert hasattr(spec.driver(c.traffic["driver"]), "Driver")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(spec.metric_reader(m["name"]).read)
        if "_roofline" in m["name"]:
            k = spec.kernel(m["name"].split("_roofline")[0])
            assert k.PATTERN and k.WRAP and callable(k.bound_s)
    # every number the drivers compare has a limit
    assert c.limits and all("max" in v for v in c.limits.values())


def test_configs_are_used_and_files_exist():
    used = {w["config"] for w in BENCH["workloads"]}
    for cfg in BENCH["configs"]:
        assert cfg["name"] in used
        path = ROOT / cfg["file"]
        assert path.exists() and path.parts[len(ROOT.parts)] == "portbench"
        data = json.loads(path.read_text())
        assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"] == []
        assert cfg["source"].startswith("https://")


def test_names_units_and_keys_keep_to_the_contract():
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\t" not in w["why"] and "\n" not in w["why"]
    assert [m["name"] for m in BENCH["end_to_end"]] == ["setup_s", "embed_samples_per_s"]
    for f in PB.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


# -- counters ---------------------------------------------------------------


def test_k1_counts_by_hand():
    k1 = spec.kernel("k1")
    # the ViT-L/14 image shape: B 256, S 257, 16 heads x 64, bf16
    assert k1.bytes_moved(256, 257, 16, 64, 2) == 4 * 256 * 16 * 257 * 64 * 2
    assert k1.operations(256, 257, 16, 64, False) == 4 * 256 * 16 * 257 * 257 * 64
    assert k1.operations(1, 3, 1, 2, True) == 4 * 1 * 1 * 6 * 2  # 3 + 2 + 1 pairs
    t = k1.bound_s((256, 257, 16, 64, False, 2))
    assert math.isclose(t * 1e3, 0.1609, rel_tol=2e-3)  # chip_smoke's bound at the same shape (bytes)
    import torch

    assert k1.shape_of((torch.zeros(2, 5, 12), None, None, 3), {"causal": True}) == (2, 5, 3, 4, True, 4)


def test_model_flops_by_hand():
    cfg = json.loads((PB / "configs" / "vit-l-14.json").read_text())
    img, txt = flops.image_tower(cfg), flops.text_tower(cfg)
    assert 160e9 < img < 164e9 and 12.5e9 < txt < 13.5e9  # ~175 GFLOP a pair
    tiny = {"context_length": 3, "text_width": 2, "text_mlp_ratio": 1.0, "text_layers": 1, "embed_dim": 1}
    # 2*3*(4*4 + 2*4) per-token products + 4*6*2 causal attention + 2*2*1 projection
    assert flops.text_tower(tiny) == 2 * 3 * 24 + 48 + 4


# -- rehearsal on the CPU ----------------------------------------------------


def _tiny(cell: str, config: str, traffic: str, **overrides):
    c = spec.resolve(cell)
    c.config = json.loads((DATA / config).read_text())
    c.traffic = json.loads((DATA / traffic).read_text())
    c.traffic.update(overrides)
    return c


TINY = {
    "embed.vit-l-14.jpeg": ("tiny.json", "tiny-jpeg.json"),
}


def _execute(cell, tmp_path, trace=False, controls=(), seed=2**31 + 5):
    import torch

    import run

    return run.execute(cell, seed, 0.6, trace, torch.device("cpu"), str(tmp_path), controls=controls)


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_prints_a_well_formed_line(name, trace, tmp_path):
    cell = _tiny(name, *TINY[name])
    result, checks = _execute(cell, tmp_path, trace=trace)
    result.pop("notes")
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks" and set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["correct"] is True, checks
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["value"] >= 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert not guard.forbidden_loaded()


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_window_is_one_partition_cut_at_its_seconds(name, tmp_path):
    """One runner call over a partition whose keys cycle over the corpus: the
    warm batches come first, and no batch is taken once the window's seconds
    have passed."""
    cell = _tiny(name, *TINY[name], window_rate_cap=10**4)
    result, checks = _execute(cell, tmp_path)
    notes, bs = result["notes"], cell.traffic["batch_size"]
    assert result["correct"] is True, checks
    assert len(notes["warm_batch_gaps_ms"]) == cell.traffic["warm_batches"] - 1
    assert notes["partition_keys"] > result["attempted"] > cell.traffic["samples"]  # keys cycle over the corpus
    assert result["attempted"] == bs * len(notes["batch_gaps_ms"])


@pytest.mark.parametrize("name,control", [
    ("embed.vit-l-14.jpeg", {"image_precision": "fp8", "text_precision": "fp8"}),
])
def test_control_is_not_correct(name, control, tmp_path):
    """The reference in the precision below the configuration's, put in the
    program's place, fails one of the cell's numbers under its limits."""
    cell = _tiny(name, *TINY[name])
    result, _ = _execute(cell, tmp_path, controls=(control,))
    ctl = result["notes"]["controls"][0]["checks"]
    assert any(c["value"] > c["limit"] for c in ctl.values()), ctl


def _alter_embeddings(monkeypatch):
    from clip_retrieval_tpu_torch.inference import mapper

    orig = mapper.tclip.encode_image

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        return out.roll(1, dims=0)  # each image gets its neighbour's embedding

    monkeypatch.setattr(mapper.tclip, "encode_image", altered)


def _drop_half(monkeypatch):
    from clip_retrieval_tpu_torch.inference import writer

    orig = writer.NumpyWriter.__call__

    def half(self, sample):
        n = len(sample["text"]) // 2  # each batch's first half written, the rest left out
        return orig(self, {k: v[:n] for k, v in sample.items()})

    monkeypatch.setattr(writer.NumpyWriter, "__call__", half)


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("fault", [_alter_embeddings, _drop_half])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch, tmp_path):
    """The timed path broken underneath (an embedding altered where it is
    produced; half of each batch left out): the rest of the run is driven as
    usual, and `correct` comes out false."""
    cell = _tiny(name, *TINY[name], check_rows=10**6)
    fault(monkeypatch)
    result, checks = _execute(cell, tmp_path)
    assert result["correct"] is False, checks


def test_no_card_no_result(tmp_path):
    """run.py on a machine without a card, or in a directory holding only the
    benchmark's files, exits non-zero and prints no result line."""
    import torch

    args = ["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        p = subprocess.run([sys.executable, str(PB / "run.py"), *args], capture_output=True, text=True, cwd=ROOT,
                           timeout=300)
        assert p.returncode != 0 and not p.stdout.strip()
    bare = tmp_path / "bare"
    shutil.copytree(PB, bare / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", *args], capture_output=True, text=True, cwd=bare,
                       timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    """One short run of the first cell on the card (skips without one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "7",
                        "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


# -- imports ------------------------------------------------------------------


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module)
    return out


def test_nothing_imports_jax_or_the_jax_package():
    for f in PB.rglob("*.py"):
        for mod in _imports(f):
            assert guard.top_level(mod) not in guard.FORBIDDEN, f"{f}: {mod}"
    for f in (PB / "reference").rglob("*.py"):
        for mod in _imports(f):
            assert guard.top_level(mod) != guard.PROGRAM, f"{f}: the reference imports the program ({mod})"
    assert guard.forbidden_loaded(["clip_retrieval_tpu_torch.models", "numpy"]) == []
    assert guard.forbidden_loaded(["clip_retrieval_tpu.models", "jax.numpy"]) == ["clip_retrieval_tpu.models",
                                                                                  "jax.numpy"]


def test_no_file_reads_the_old_benchmarks_folder():
    for f in PB.rglob("*.py"):
        text = f.read_text()
        assert not re.search(r"['\"/]benchmarks[/'\"]", text), f

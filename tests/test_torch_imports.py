"""The port imports neither jax nor the JAX package, and never falls back to
the CPU by itself.

Importing every module of `clip_retrieval_tpu_torch` (and `chip_smoke.py`)
in a fresh interpreter must leave `jax` and every `clip_retrieval_tpu` /
`clip_retrieval_tpu.*` module out of `sys.modules` (this test process has
both loaded by tests/conftest.py, hence the subprocess), and no source of
the port may import them.  Entry points, index classes and loaders default
to device="cuda" and raise when no GPU is visible.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_retrieval_tpu_torch import cli
from clip_retrieval_tpu_torch.inference.distributor import make_distributor
from clip_retrieval_tpu_torch.inference.main import main as torch_inference
from clip_retrieval_tpu_torch.inference.mapper import ClipMapper

from tests.test_inference.fixtures import make_files_corpus

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "clip_retrieval_tpu_torch"


def _run(code: str, **env):
    full_env = {**os.environ, **env}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full_env, capture_output=True, text=True,
                          timeout=300)


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import clip_retrieval_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'clip_retrieval_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib')))\n"
        "print('OK' if not bad else 'JAX ' + ' '.join(bad[:5]))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK"), proc.stdout


def test_sources_have_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert not offenders


def test_importing_the_port_and_chip_smoke_leaves_the_jax_package_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import clip_retrieval_tpu_torch as p\n"
        "import chip_smoke\n"
        "for m in pkgutil.walk_packages(p.__path__, 'clip_retrieval_tpu_torch.'): importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'clip_retrieval_tpu' or k.startswith('clip_retrieval_tpu.'))\n"
        "print('OK' if not bad else 'JAX PACKAGE ' + ' '.join(bad[:5]))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK"), proc.stdout


def test_sources_have_no_import_of_the_jax_package():
    """Static: no port module and not chip_smoke.py names the JAX package in
    an import (the exact name `clip_retrieval_tpu_torch` does not count)."""
    pattern = re.compile(r"^\s*(from|import)\s+clip_retrieval_tpu(\.|\s|$)", re.M)
    files = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders


# the modules of slice 4 (shard → combine → reorder → serve, and the entry points on ported code)
SLICE4 = ["clip_retrieval_tpu_torch.index.combiner", "clip_retrieval_tpu_torch.index.metadata_order",
          "clip_retrieval_tpu_torch.back.prepro", "clip_retrieval_tpu_torch.filter",
          "clip_retrieval_tpu_torch.end2end", "clip_retrieval_tpu_torch.client", "clip_retrieval_tpu_torch.front",
          "clip_retrieval_tpu_torch.tools.sweep_routes", "chip_smoke"]


@pytest.mark.parametrize("module", SLICE4)
def test_slice4_sources_import_neither_jax_nor_the_jax_package(module):
    text = (ROOT / (module.replace(".", "/") + ".py")).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(from|import)\s+clip_retrieval_tpu(\.|\s|$)", text, re.M)


def test_importing_the_slice4_modules_leaves_both_out():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE4!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'clip_retrieval_tpu') or k.startswith(('jax.', "
        "'jaxlib', 'clip_retrieval_tpu.')))\n"
        "print('OK' if not bad else 'BAD ' + ' '.join(bad[:5]))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK"), proc.stdout


# the modules of slice 5 (the ResNet and M-CLIP families, checkpoint conversion)
SLICE5 = ["clip_retrieval_tpu_torch.models.resnet", "clip_retrieval_tpu_torch.models.mclip",
          "clip_retrieval_tpu_torch.models.convert"]
OPTIONAL = ("transformers", "tokenizers", "safetensors", "tensorflow", "tf_keras")


@pytest.mark.parametrize("module", SLICE5)
def test_slice5_sources_import_neither_jax_the_jax_package_nor_optional_packages_at_top(module):
    """No import of jax or the JAX package anywhere; `transformers`,
    `tokenizers`, `safetensors` and `tensorflow` only inside functions."""
    text = (ROOT / (module.replace(".", "/") + ".py")).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(from|import)\s+clip_retrieval_tpu(\.|\s|$)", text, re.M)
    assert not re.search(rf"^(import|from) ({'|'.join(OPTIONAL)})\b", text, re.M)


def test_importing_the_port_loads_no_optional_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import clip_retrieval_tpu_torch as p\n"
        "import chip_smoke\n"
        "for m in pkgutil.walk_packages(p.__path__, 'clip_retrieval_tpu_torch.'): importlib.import_module(m.name)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {OPTIONAL!r})\n"
        "print('OK' if not bad else 'LOADED ' + ' '.join(bad[:5]))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK"), proc.stdout


@pytest.mark.parametrize("module", ["clip_retrieval_tpu_torch", "clip_retrieval_tpu_torch.index",
                                    "clip_retrieval_tpu_torch.models"])
def test_importing_the_package_and_its_api_subpackages_stays_light(module):
    """The package-level API and the index re-exports resolve lazily: the
    package loads no torch and `.index` none of its modules.  None of the
    three loads jax, the JAX package or an optional package, or touches
    CUDA."""
    banned = OPTIONAL + ("jax", "jaxlib", "clip_retrieval_tpu")
    code = (
        f"import sys, {module}\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {banned!r})\n"
        "torch = sys.modules.get('torch')\n"
        "if torch is not None and torch.cuda.is_initialized(): bad.append('CUDA')\n"
        "port = sorted(k for k in sys.modules if k.startswith('clip_retrieval_tpu_torch'))\n"
        "print('OK' if not bad else 'LOADED ' + ' '.join(bad[:5]), 'torch' in sys.modules, port)\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    verdict, torch_loaded, port = proc.stdout.strip().split(" ", 2)
    assert verdict == "OK", proc.stdout
    if module != "clip_retrieval_tpu_torch.models":
        assert torch_loaded == "False" and port == repr(sorted({"clip_retrieval_tpu_torch", module}))


def test_new_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """`filter`, `end2end` and `index_combiner` raise on their default
    device without a GPU, before any work; `parquet_to_arrow`, `clip_front`
    and `ClipClient` touch no device and take none."""
    import dataclasses
    import inspect

    from clip_retrieval_tpu_torch.back.prepro import parquet_to_arrow
    from clip_retrieval_tpu_torch.client import ClipClient
    from clip_retrieval_tpu_torch.end2end import clip_end2end
    from clip_retrieval_tpu_torch.filter import clip_filter
    from clip_retrieval_tpu_torch.front import clip_front
    from clip_retrieval_tpu_torch.index.combiner import index_combiner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: clip_filter("q", str(tmp_path / "f"), str(tmp_path / "missing")),
        lambda: clip_end2end(output_folder=str(tmp_path / "e"), input_dataset="x"),
        lambda: index_combiner(str(tmp_path / "missing"), str(tmp_path / "m")),
    ):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert not list(tmp_path.iterdir())
    for fn in (parquet_to_arrow, clip_front):
        assert "device" not in inspect.signature(fn).parameters
    assert "device" not in {f.name for f in dataclasses.fields(ClipClient)}


def test_mapper_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ClipMapper(enable_image=True, enable_text=True, clip_model="test-tiny")


def test_main_default_device_raises_before_work(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dataset = make_files_corpus(str(tmp_path / "c"), n=2)
    with pytest.raises(RuntimeError, match="is_available"):
        torch_inference(input_dataset=dataset, output_folder=str(tmp_path / "out"), clip_model="test-tiny")
    assert not (tmp_path / "out").exists()


def test_serving_entry_points_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from clip_retrieval_tpu_torch.back.app import clip_back
    from clip_retrieval_tpu_torch.back.knn import KnnService
    from clip_retrieval_tpu_torch.index.store import load_index

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        clip_back(indices_paths=str(tmp_path / "missing.json"), clip_model="test-tiny")
    with pytest.raises(RuntimeError, match="is_available"):
        load_index(str(tmp_path / "missing_index"))
    with pytest.raises(RuntimeError, match="is_available"):
        KnnService({})


def test_index_classes_loaders_and_clip_index_default_to_cuda(monkeypatch, tmp_path):
    import numpy as np

    from clip_retrieval_tpu_torch.index.build import clip_index
    from clip_retrieval_tpu_torch.index.flat import FlatIndex
    from clip_retrieval_tpu_torch.index.ivf_int8 import IVFInt8Index
    from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex
    from clip_retrieval_tpu_torch.models.zoo import load_model

    ivf = IVFInt8Index(4, np.zeros((2, 4), np.float32), np.zeros(3, np.int64), np.zeros(0, np.int64),
                       np.zeros((0, 4), np.int8), np.zeros(0, np.float32), device="cpu")
    ivf.save(str(tmp_path / "ivf"))
    pq = IVFPQIndex(4, np.zeros((2, 4), np.float32), np.zeros((2, 256, 2), np.float32), None, np.zeros(3, np.int64),
                    np.zeros(0, np.int64), np.zeros((0, 2), np.uint8), device="cpu")
    pq.save(str(tmp_path / "pq"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: clip_index(str(tmp_path / "no_embeddings"), str(tmp_path / "out")),
        lambda: IVFPQIndex.load(str(tmp_path / "pq")),
        lambda: IVFInt8Index.load(str(tmp_path / "ivf")),
        lambda: FlatIndex(4),
        lambda: load_model("test-tiny"),
    ):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert not (tmp_path / "out").exists()


def test_model_init_and_safety_loaders_default_to_cuda(monkeypatch, tmp_path):
    import numpy as np

    from clip_retrieval_tpu_torch.models import safety
    from clip_retrieval_tpu_torch.models.clip import init_clip
    from clip_retrieval_tpu_torch.models.configs import TEST_TINY
    from clip_retrieval_tpu_torch.models.preprocess import resize_on_device

    monkeypatch.setenv("HOME", str(tmp_path))
    path = str(tmp_path / "nsfw_mlp.npz")
    safety.save_mlp_npz(path, [(np.ones((4, 1), np.float32), np.zeros((1,), np.float32))])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: init_clip(TEST_TINY, 0),
        lambda: safety.MLP([(np.ones((4, 1), np.float32), np.zeros((1,), np.float32))]),
        lambda: safety.MLP.random(4),
        lambda: safety.load_safety_model("ViT-L/14"),
        lambda: safety.load_mlp_npz(path),
        lambda: resize_on_device(np.zeros((1, 4, 4, 3), np.uint8), 2),
    ):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert safety.load_mlp_npz(path, device="cpu").device.type == "cpu"
    assert resize_on_device(np.zeros((1, 4, 4, 3), np.uint8), 2, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("loader", ["from_jax_params", "convert_hf_state_dict", "convert_openai_state_dict",
                                    "convert_state_dict", "load_checkpoint"])
def test_checkpoint_loaders_default_to_cuda(monkeypatch, tmp_path, loader):
    """Without a GPU each loader raises on its default device before it
    reads anything; given device="cpu" it gets as far as the (empty)
    checkpoint."""
    from clip_retrieval_tpu_torch.models import loaders
    from clip_retrieval_tpu_torch.models.configs import TEST_TINY

    source = str(tmp_path / "missing.pt") if loader == "load_checkpoint" else {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        getattr(loaders, loader)(source, TEST_TINY)
    with pytest.raises((KeyError, ValueError, FileNotFoundError)):
        getattr(loaders, loader)(source, TEST_TINY, device="cpu")


def test_cli_index_help(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["index", "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--embeddings_folder" in out and "--index_folder" in out and "--device" in out


def test_cli_back_help(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["back", "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--indices_paths" in out and "--device" in out and "--clip_model" in out


def test_cli_inference_on_cpu(tmp_path):
    dataset = make_files_corpus(str(tmp_path / "c"), n=5)
    out = tmp_path / "out"
    cli.main(["inference", "--input_dataset", dataset, "--output_folder", str(out), "--clip_model", "test-tiny",
              "--batch_size", "2", "--num_prepro_workers", "1", "--device", "cpu"])
    import numpy as np

    emb = np.load(out / "img_emb" / "img_emb_0.npy")
    assert emb.shape == (5, 32) and emb.dtype == np.float16


@pytest.mark.parametrize("strategy", ["pod", "slurm", "pyspark"])
def test_unported_distributors_name_the_roadmap(strategy):
    """Every strategy is ported now: make_distributor builds its class
    without importing pyspark or touching slurm."""
    from clip_retrieval_tpu_torch.inference import distributor, slurm

    want = {"pod": distributor.PodDistributor, "slurm": slurm.SlurmDistributor,
            "pyspark": distributor.PysparkDistributor}[strategy]
    assert type(make_distributor(strategy, [0], {})) is want


# the modules of slice 6 (scale-out: distributors, sharded tiers, the train step)
SLICE6 = ["clip_retrieval_tpu_torch.parallel.dist", "clip_retrieval_tpu_torch.parallel.train",
          "clip_retrieval_tpu_torch.inference.distributor", "clip_retrieval_tpu_torch.inference.slurm",
          "clip_retrieval_tpu_torch.inference.slurm_worker", "clip_retrieval_tpu_torch.index.sharded_ivf",
          "clip_retrieval_tpu_torch.index.sharded_flat", "clip_retrieval_tpu_torch.index.store",
          "clip_retrieval_tpu_torch.tools.scale_out"]


@pytest.mark.parametrize("module", SLICE6)
def test_slice6_sources_import_neither_jax_nor_the_jax_package(module):
    text = (ROOT / (module.replace(".", "/") + ".py")).read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(from|import)\s+(clip_retrieval_tpu|optax)(\.|\s|$)", text, re.M)
    assert not re.search(r"^(from|import)\s+pyspark\b", text, re.M)  # only inside the Spark distributor's call


def test_importing_the_slice6_modules_leaves_both_out():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE6!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'clip_retrieval_tpu', "
        "'optax', 'pyspark'))\n"
        "print('OK' if not bad else 'BAD ' + ' '.join(bad[:5]))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK"), proc.stdout


def test_scale_out_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The sharded tiers' default devices (every visible card), the train
    step and the pod ranks raise without a GPU, before any work."""
    from clip_retrieval_tpu_torch.index.sharded_flat import ShardedFlatIndex
    from clip_retrieval_tpu_torch.index.sharded_ivf import ShardedIVFInt8Index
    from clip_retrieval_tpu_torch.models.configs import TEST_TINY
    from clip_retrieval_tpu_torch.parallel.train import make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ivf = lambda **kw: ShardedIVFInt8Index(4, np.zeros((2, 4), np.float32), np.zeros(3, np.int64),  # noqa: E731
                                           np.zeros(0, np.int64), np.zeros((0, 4), np.int8), np.zeros(0, np.float32),
                                           **kw)
    for call in (lambda: ShardedFlatIndex(4, np.zeros((1, 4), np.int8), np.ones(1, np.float32)),
                 lambda: ShardedIVFInt8Index.from_vectors(np.eye(4, dtype=np.float32), 2),
                 lambda: ivf(), lambda: ivf(devices=["cpu", "cuda"]),
                 lambda: make_train_step(TEST_TINY)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert ivf(devices=["cpu", "cpu"]).devices == [torch.device("cpu")] * 2
    dataset = make_files_corpus(str(tmp_path / "c"), n=2)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="is_available"):
        torch_inference(input_dataset=dataset, output_folder=str(tmp_path / "out"), clip_model="test-tiny",
                        distribution_strategy="pod")
    assert not (tmp_path / "out").exists()


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

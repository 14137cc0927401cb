"""The gated artifact fetch of `models/safety.py`, port against JAX.

With CRT_ALLOW_DOWNLOAD=1 both packages fetch, at four sites, what the
reference fetches: the autokeras NSFW zip (ViT-L/14), the H14 NSFW
checkpoint, the violence prompt embeddings and the ten aesthetic rating
embeddings.  `urllib.request.urlretrieve` is replaced by a stub that copies
local fixture files (nothing touches the network), and each package gets
its own `HOME` under `tmp_path`.  Both must request the same URLs in the
same order, write the same paths under `HOME` and load equal arrays.
Without the variable neither calls `urlretrieve`; with a fetch that fails
neither loads anything.  Every site then returns None.
"""

import os
import shutil
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_retrieval_tpu.models import safety as jsafety
from clip_retrieval_tpu_torch.models import safety as tsafety

from tests.test_models.test_published_weights import _make_savedmodel

SITES = ["nsfw_zip", "h14", "violence", "aesthetic"]
# the artifact each site asks for: (clip_model, the call for a package's safety module)
CALLS = {
    "nsfw_zip": ("ViT-L/14", lambda m, pkg: m.load_safety_model("ViT-L/14", **pkg)),
    "h14": ("open_clip:ViT-H-14", lambda m, pkg: m.load_safety_model("open_clip:ViT-H-14", **pkg)),
    "violence": ("ViT-L/14", lambda m, pkg: m.load_violence_detector("ViT-L/14")),
    "aesthetic": ("ViT-L/14", lambda m, pkg: m.get_aesthetic_embedding("ViT-L/14")),
}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """URL → local file, for every URL the four sites request."""
    root = tmp_path_factory.mktemp("artifacts")
    rng = np.random.default_rng(0)
    files = {}
    url, dirname = jsafety._NSFW_ZIP_URLS["ViT-L/14"]
    if _has_tensorflow():
        _make_savedmodel(root / "sm" / dirname, in_dim=24, seed=3)
        files[url] = shutil.make_archive(str(root / dirname), "zip", root_dir=str(root / "sm"))
    sd = {"layers.0.weight": torch.from_numpy(rng.normal(size=(16, 24)).astype(np.float32)),
          "layers.0.bias": torch.from_numpy(rng.normal(size=16).astype(np.float32)),
          "layers.2.weight": torch.from_numpy(rng.normal(size=(1, 16)).astype(np.float32)),
          "layers.2.bias": torch.zeros(1)}
    torch.save(sd, root / "h14_nsfw.pth")
    files["https://github.com/LAION-AI/CLIP-based-NSFW-Detector/raw/main/h14_nsfw.pth"] = str(root / "h14_nsfw.pth")
    np.save(root / "violence.npy", rng.normal(size=(6, 24)).astype(np.float32))
    files["https://github.com/LAION-AI/CLIP-based-NSFW-Detector/raw/main/violence_detection_vit_l_14.npy"] = str(
        root / "violence.npy")
    for k in range(10):
        np.save(root / f"rating{k}.npy", rng.normal(size=(1, 24)).astype(np.float32))
        files[f"https://github.com/LAION-AI/aesthetic-predictor/blob/main/vit_l_14_embeddings/rating{k}.npy?raw=true"] \
            = str(root / f"rating{k}.npy")
    return files


def _has_tensorflow() -> bool:
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        return False
    return True


def _fetch(module, site: str, home: Path, monkeypatch, files: dict, failing: bool = False):
    """Run one site of one package under HOME=home; returns (result,
    [(url, dest relative to home)])."""
    requests = []

    def urlretrieve(url, dest):
        requests.append((url, os.path.relpath(dest, home)))
        if failing:
            raise OSError("network is unreachable")
        shutil.copyfile(files[url], dest)
        return dest, None

    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    _, call = CALLS[site]
    return call(module, {"device": "cpu"} if module is tsafety else {}), requests


def _arrays(result, site: str) -> list:
    if site in ("nsfw_zip", "h14"):
        return [np.asarray(a) for wb in result.weights for a in wb] + [str(result.final_activation), result.skip]
    if site == "violence":
        return [result]
    return [result[k] for k in range(10)]


@pytest.mark.parametrize("site", SITES)
def test_allowed_fetch_matches_jax(site, artifacts, tmp_path, monkeypatch, capsys):
    if site == "nsfw_zip" and not _has_tensorflow():
        pytest.skip("the autokeras zip converts through tensorflow, which is not installed")
    monkeypatch.setenv("CRT_ALLOW_DOWNLOAD", "1")
    theirs, their_requests = _fetch(jsafety, site, tmp_path / "jax", monkeypatch, artifacts)
    ours, our_requests = _fetch(tsafety, site, tmp_path / "torch", monkeypatch, artifacts)
    assert our_requests == their_requests and our_requests
    assert all(url in artifacts for url, _ in our_requests)
    for _, dest in our_requests:
        assert (tmp_path / "torch" / dest).is_file()
    assert theirs is not None and ours is not None
    for a, b in zip(_arrays(ours, site), _arrays(theirs, site), strict=True):
        np.testing.assert_array_equal(a, b)
    if site == "nsfw_zip":  # converted once and cached where either package looks first
        npz = Path(".cache/clip_retrieval_tpu/ViT-L_14/nsfw_mlp.npz")
        assert (tmp_path / "torch" / npz).is_file() and (tmp_path / "jax" / npz).is_file()
    assert "WARNING" not in capsys.readouterr().out


@pytest.mark.parametrize("site", SITES)
def test_nothing_is_fetched_without_the_variable(site, artifacts, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("CRT_ALLOW_DOWNLOAD", raising=False)
    theirs, their_requests = _fetch(jsafety, site, tmp_path / "jax", monkeypatch, artifacts)
    ours, our_requests = _fetch(tsafety, site, tmp_path / "torch", monkeypatch, artifacts)
    assert our_requests == their_requests == []
    assert ours is None and theirs is None
    warnings = [line for line in capsys.readouterr().out.splitlines() if line.startswith("WARNING")]
    assert len(warnings) == 2 and warnings[0] == warnings[1]


@pytest.mark.parametrize("site", SITES)
def test_failed_fetch_loads_nothing(site, artifacts, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CRT_ALLOW_DOWNLOAD", "1")
    theirs, their_requests = _fetch(jsafety, site, tmp_path / "jax", monkeypatch, artifacts, failing=True)
    ours, our_requests = _fetch(tsafety, site, tmp_path / "torch", monkeypatch, artifacts, failing=True)
    assert our_requests == their_requests and len(our_requests) == 1  # the aesthetic set stops at its first failure
    assert ours is None and theirs is None
    out = capsys.readouterr().out
    assert out.count(f"download of {our_requests[0][0]} failed: network is unreachable") == 2

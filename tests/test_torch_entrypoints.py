"""The port's user-facing entry points against the JAX package's, on the CPU:
`filter.clip_filter`, `end2end.clip_end2end`, the CLI's subcommands and the
parameters of every ported entry point.

Both packages load the same checkpoint (the tiny random HF CLIPModel of
tests/test_torch_pipeline.py) and see the same corpus.  `clip_filter` must
copy the same files in both packages for a text query, a threshold (range
search) query and an image-file query, with the distances it found within
1e-4 (two implementations of one f32 model).  `clip_end2end` (files and
webdataset, `run_back=False`) must write the same folder layout, metadata
and index, with embeddings at the towers' bar (cosine ≥ 0.999, atol 2e-4),
and its index serves in-process.
"""

import dataclasses
import importlib
import inspect
import json
import os

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from clip_retrieval_tpu.end2end import clip_end2end as jax_end2end
from clip_retrieval_tpu.filter import clip_filter as jax_filter
from clip_retrieval_tpu.index import store as j_store
from clip_retrieval_tpu.index.build import clip_index as jax_clip_index
from clip_retrieval_tpu_torch import cli
from clip_retrieval_tpu_torch.back.app import make_app
from clip_retrieval_tpu_torch.back.options import ClipOptions
from clip_retrieval_tpu_torch.back.resources import load_clip_indices
from clip_retrieval_tpu_torch.end2end import clip_end2end as torch_end2end
from clip_retrieval_tpu_torch.filter import clip_filter as torch_filter
from clip_retrieval_tpu_torch.index import store as t_store

from tests.test_back.wsgi_client import request
from tests.test_inference.fixtures import make_files_corpus, make_tar_corpus
from tests.test_torch_pipeline import checkpoint  # noqa: F401  (module fixture)

D = 32  # the checkpoint's embed dim
DIST_ATOL = 1e-4
SUBCOMMANDS = ["inference", "index", "filter", "back", "front", "end2end", "index_combiner", "parquet_to_arrow",
               "inference.worker", "inference.slurm_worker", "convert", "convert.nsfw_keras"]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# -- clip_filter ------------------------------------------------------------


@pytest.fixture(scope="module")
def filter_corpus(tmp_path_factory):
    """60 seeded unit embeddings with an image file and a url each, indexed
    Flat by the JAX `clip_index` (tests/test_filter.py's corpus)."""
    root = tmp_path_factory.mktemp("filter")
    emb = root / "emb"
    (emb / "img_emb").mkdir(parents=True)
    (emb / "metadata").mkdir(parents=True)
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    n = 60
    np.save(emb / "img_emb" / "img_emb_0.npy", _unit(rng.normal(size=(n, D))).astype(np.float16))
    paths = []
    for i in range(n):
        p = str(root / "imgs" / f"im{i:03d}.jpg")
        Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    pd.DataFrame({"image_path": paths, "url": [f"http://x/{i}.jpg" for i in range(n)],
                  "caption": [f"c{i}" for i in range(n)]}).to_parquet(emb / "metadata" / "metadata_0.parquet")
    index_folder = root / "index"
    jax_clip_index(str(emb), str(index_folder), index_key="Flat", compute_recall=False)
    return root, str(index_folder)


def _recording(monkeypatch, store, log):
    """Make `store.load_index` hand out indices whose search and
    range_search outputs are appended to `log`."""
    real = store.load_index

    def load(*args, **kwargs):
        ix = real(*args, **kwargs)
        for name in ("search", "range_search"):
            fn = getattr(ix, name, None)
            if fn is not None:
                setattr(ix, name, lambda *a, _fn=fn, _n=name: log.append((_n, _fn(*a))) or log[-1][1])
        return ix

    monkeypatch.setattr(store, "load_index", load)


def _found(log):
    """(ids, distances) of the one search a clip_filter call made."""
    (name, out), = log
    if name == "range_search":
        _, d, i = out
    else:
        d, i = out[0][0], out[1][0]
    order = np.argsort(i)
    return i[order], d[order]


@pytest.mark.parametrize("query,kw", [
    ("a red square", {"num_results": 5}),
    ("anything at all", {"threshold": "median"}),
    ("IMAGE", {"num_results": 3}),
], ids=["text-topk", "text-threshold", "image-file"])
def test_filter_copies_the_files_jax_copies(filter_corpus, checkpoint, tmp_path, monkeypatch, capsys,  # noqa: F811
                                            query, kw):
    ckpt, bpe = checkpoint
    monkeypatch.setenv("CRT_BPE_PATH", bpe)
    root, index_folder = filter_corpus
    if query == "IMAGE":
        query = str(root / "imgs" / "im007.jpg")
    logs = {"jax": [], "torch": []}
    _recording(monkeypatch, j_store, logs["jax"])
    _recording(monkeypatch, t_store, logs["torch"])
    if kw.get("threshold") == "median":  # a threshold that splits the corpus
        jax_filter(query, str(tmp_path / "probe"), index_folder, num_results=60, clip_model=f"test-tiny:{ckpt}")
        kw = {"threshold": float(np.median(logs["jax"].pop()[1][0]))}
        capsys.readouterr()
    common = dict(query=query, indice_folder=index_folder, clip_model=f"test-tiny:{ckpt}", **kw)
    jax_filter(output_folder=str(tmp_path / "jax"), **common)
    jax_out = capsys.readouterr().out
    torch_filter(output_folder=str(tmp_path / "torch"), device="cpu", **common)
    torch_out = capsys.readouterr().out
    copied = sorted(os.listdir(tmp_path / "torch"))
    assert copied == sorted(os.listdir(tmp_path / "jax"))
    jid, jd = _found(logs["jax"])
    tid, td = _found(logs["torch"])
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_allclose(td, jd, atol=DIST_ATOL, rtol=0)
    assert copied == sorted(f"im{i:03d}.jpg" for i in tid) and 0 < len(copied) < 60
    urls = [line for line in torch_out.splitlines() if line.startswith("http://x/")]
    assert sorted(urls) == sorted(line for line in jax_out.splitlines() if line.startswith("http://x/"))
    assert len(urls) == len(copied)


def test_filter_threshold_needs_range_search(filter_corpus, checkpoint, tmp_path, monkeypatch):  # noqa: F811
    ckpt, bpe = checkpoint
    monkeypatch.setenv("CRT_BPE_PATH", bpe)
    _, index_folder = filter_corpus
    real = t_store.load_index
    monkeypatch.setattr(t_store, "load_index", lambda *a, **k: type("NoRange", (), {
        "search": real(*a, **k).search})())
    with pytest.raises(ValueError, match="range_search"):
        torch_filter("x", str(tmp_path / "o"), index_folder, threshold=0.0, clip_model=f"test-tiny:{ckpt}",
                     device="cpu")


# -- clip_end2end -----------------------------------------------------------


def _listing(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder) for d, _, files in os.walk(folder) for f in files)


@pytest.mark.parametrize("input_format", ["files", "webdataset"])
def test_end2end_matches_jax_and_serves(tmp_path, checkpoint, monkeypatch, input_format):  # noqa: F811
    ckpt, bpe = checkpoint
    monkeypatch.setenv("CRT_BPE_PATH", bpe)
    if input_format == "files":
        dataset = make_files_corpus(str(tmp_path / "corpus"), n=24, with_text=True, with_meta=True)
    else:
        dataset = make_tar_corpus(str(tmp_path / "tars"), sizes=(8, 8, 8), with_meta=True)
    common = dict(input_dataset=dataset, input_format=input_format, run_back=False, clip_model=f"test-tiny:{ckpt}",
                  batch_size=8)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_end2end(output_folder=out_j, **common)
    torch_end2end(output_folder=out_t, device="cpu", **common)

    files = _listing(out_t)
    assert files == _listing(out_j)
    for sub in ("embeddings/img_emb/img_emb_0.npy", "index/image.index/header.json", "index/text.index/header.json",
                "indices_paths.json", "index/metadata/metadata_0.parquet"):
        assert sub in files
    for rel in files:
        pj, pt = os.path.join(out_j, rel), os.path.join(out_t, rel)
        if rel.startswith("embeddings/") and rel.endswith(".npy"):
            a, b = np.load(pj).astype(np.float32), np.load(pt).astype(np.float32)
            assert a.shape == b.shape and a.shape[1] == D, rel
            cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
            assert cos.min() >= 0.999, rel
            np.testing.assert_allclose(b, a, atol=2e-4, rtol=0, err_msg=rel)
        elif rel.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(pj), pd.read_parquet(pt))
        elif rel == "indices_paths.json":
            with open(pj) as fj, open(pt) as ft:
                assert list(json.load(fj)) == ["example_index"]
                assert json.load(ft) == {"example_index": os.path.join(out_t, "index")}
        elif rel.endswith("header.json"):
            with open(pj) as fj, open(pt) as ft:
                assert json.load(ft) == json.load(fj), rel
    # the same index ids: every stored row finds itself first in both packages' indices
    jx = j_store.load_index(os.path.join(out_j, "index", "image.index"))
    tx = t_store.load_index(os.path.join(out_t, "index", "image.index"), device="cpu")
    rows = np.load(os.path.join(out_t, "embeddings", "img_emb", "img_emb_0.npy")).astype(np.float32)
    ti, ji = tx.search(rows, 1)[1][:, 0], jx.search(rows, 1)[1][:, 0]
    np.testing.assert_array_equal(ti, np.arange(24))
    np.testing.assert_array_equal(ji, np.arange(24))

    # the written indices_paths.json serves in-process
    resources = load_clip_indices(os.path.join(out_t, "indices_paths.json"), ClipOptions(
        clip_model=f"test-tiny:{ckpt}", columns_to_return=["caption", "image_path"],
        provide_aesthetic_embeddings=False, device="cpu"))
    app = make_app(resources, device="cpu")
    for modality, n in (("image", 5), ("text", 3)):
        r = request(app, "POST", "/knn-service", {"text": "caption number 3", "modality": modality, "num_images": n,
                                                  "indice_name": "example_index"})
        assert r["status"].startswith("200"), r["body"]
        assert len(r["json"]) == n and all("caption" in item and "id" in item for item in r["json"])


def test_end2end_refuses_a_remote_output_folder():
    with pytest.raises(ValueError, match="local output_folder"):
        torch_end2end(output_folder="s3://bucket/out", input_dataset="x", device="cpu")
    with pytest.raises(ValueError, match="url_list"):
        torch_end2end(output_folder="local_never_made", device="cpu")


# -- the CLI and the parameters of every entry point --------------------------


def test_help_lists_the_ported_subcommands(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    assert "{" + ",".join(sorted(SUBCOMMANDS)) + "}" in out


def test_cli_has_the_jax_cli_subcommands():
    from clip_retrieval_tpu import cli as jax_cli

    assert sorted(cli._lazy_commands()) == sorted(jax_cli._lazy_commands()) == sorted(SUBCOMMANDS)


@pytest.mark.parametrize("command", SUBCOMMANDS)
def test_subcommand_parses_help(command, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([command, "--help"])
    assert exc.value.code == 0
    assert capsys.readouterr().out.startswith(f"usage: clip-retrieval-tpu-torch {command}")


def test_inference_accepts_use_jit_and_clip_cache_path(tmp_path, capsys):
    dataset = make_files_corpus(str(tmp_path / "c"), n=3)
    out = tmp_path / "out"
    cli.main(["inference", "--input_dataset", dataset, "--output_folder", str(out), "--clip_model", "test-tiny",
              "--batch_size", "2", "--num_prepro_workers", "1", "--use_jit", "False", "--clip_cache_path", "p",
              "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "use_jit=False is accepted for CLI parity but ignored" in printed
    assert "clip_cache_path is accepted for CLI parity but ignored" in printed
    assert np.load(out / "img_emb" / "img_emb_0.npy").shape == (3, D)


ENTRY_POINTS = [("inference.main", "main"), ("index.build", "clip_index"), ("back.app", "clip_back"),
                ("index.combiner", "index_combiner"), ("back.prepro", "parquet_to_arrow"), ("front", "clip_front"),
                ("filter", "clip_filter"), ("end2end", "clip_end2end"), ("models.convert", "convert"),
                ("models.convert", "convert_keras_nsfw"), ("inference.slurm", "slurm_worker")]


def assert_parameters_match(jax_fn, torch_fn):
    """Names, order and defaults of `torch_fn`'s parameters equal
    `jax_fn`'s; `device`, last and defaulting to "cuda", is the only extra."""
    j = inspect.signature(jax_fn).parameters
    t = inspect.signature(torch_fn).parameters
    want = [(k, p.default) for k, p in j.items() if p.kind != p.VAR_KEYWORD]
    assert [(k, p.default) for k, p in t.items() if k != "device"] == want
    if "device" in t:
        assert list(t)[-1] == "device" and t["device"].default == "cuda"


@pytest.mark.parametrize("module,name", ENTRY_POINTS, ids=[f"{m}.{n}" for m, n in ENTRY_POINTS])
def test_entry_point_parameters_match_jax(module, name):
    """Names, order and defaults equal the JAX function's, `slurm_*`
    included; `device` is the only extra."""
    assert_parameters_match(getattr(importlib.import_module(f"clip_retrieval_tpu.{module}"), name),
                            getattr(importlib.import_module(f"clip_retrieval_tpu_torch.{module}"), name))


def test_clip_client_fields_match_jax():
    from clip_retrieval_tpu.client import ClipClient as JClient
    from clip_retrieval_tpu_torch.client import ClipClient as TClient

    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert [(n, getattr(d, "value", d)) for n, d in fields(TClient)] == [
        (n, getattr(d, "value", d)) for n, d in fields(JClient)]


def test_clip_front_serves_the_routes_jax_serves(monkeypatch):
    """`clip_front` hands `serve` a router with the JAX front's routes and
    the same /config.json (no device)."""
    from clip_retrieval_tpu.back import app as j_app
    from clip_retrieval_tpu.front import clip_front as jax_front
    from clip_retrieval_tpu_torch.back import app as t_app
    from clip_retrieval_tpu_torch.front import clip_front

    served = {}
    monkeypatch.setattr(t_app, "serve", lambda router, port: served.setdefault("torch", (router, port)))
    monkeypatch.setattr(j_app, "serve", lambda router, port: served.setdefault("jax", (router, port)))
    kw = dict(default_backend="http://127.0.0.1:1234", default_index="laion5B", url_column="link")
    clip_front(**kw)
    jax_front(**kw)
    (tr, tp), (jr, jp) = served["torch"], served["jax"]
    assert tp == jp == 1235
    assert sorted(tr.routes) == sorted(jr.routes) and ("GET", "/config.json") in tr.routes
    assert request(tr, "GET", "/config.json")["json"] == request(jr, "GET", "/config.json")["json"] == {
        "defaultBackend": "http://127.0.0.1:1234", "defaultIndex": "laion5B", "urlColumn": "link"}


def test_cli_inference_worker_runs_one_partition(tmp_path):
    dataset = make_files_corpus(str(tmp_path / "c"), n=3)
    out = tmp_path / "out"
    cli.main(["inference.worker", "--tasks", "[0]", "--input_dataset", dataset, "--output_folder", str(out),
              "--output_partition_count", "1", "--clip_model", "test-tiny", "--batch_size", "2",
              "--num_prepro_workers", "1", "--device", "cpu"])
    assert np.load(out / "img_emb" / "img_emb_0.npy").shape == (3, D)
    assert np.load(out / "text_emb" / "text_emb_0.npy").shape == (3, D)

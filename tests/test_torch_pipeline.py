"""The port's `inference.main` against the JAX package's on one corpus.

Both packages load the same checkpoint (a random tiny HF CLIPModel with the
`test-tiny` shapes, saved as .pt) and embed the same JPEG corpus from
tests/test_inference/fixtures.py on the CPU (`device="cpu"` for the port).
The npy, parquet and stats layout must be identical, and the embeddings
agree at cosine ≥ 0.999 per row.  The JAX package's `clip_index` then
builds a flat index from the port's output folder.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from clip_retrieval_tpu.index.build import clip_index
from clip_retrieval_tpu.inference.main import main as jax_inference
from clip_retrieval_tpu_torch.inference.main import main as torch_inference

from tests.test_inference.fixtures import make_files_corpus, make_tar_corpus

MIN_COS = 0.999


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """`test-tiny`-shaped HF weights on disk, plus a BPE file with no merges
    (a real checkpoint refuses the byte fallback; an empty merge list gives
    the same byte-level vocabulary through the BPE path)."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(
        projection_dim=32,
        text_config={
            "vocab_size": 520,
            "hidden_size": 32,
            "intermediate_size": 128,
            "num_hidden_layers": 2,
            "num_attention_heads": 4,
            "max_position_embeddings": 16,
            "hidden_act": "quick_gelu",
        },
        vision_config={
            "hidden_size": 48,
            "intermediate_size": 192,
            "num_hidden_layers": 2,
            "num_attention_heads": 4,
            "image_size": 32,
            "patch_size": 8,
            "hidden_act": "quick_gelu",
        },
    )
    torch.manual_seed(0)
    root = tmp_path_factory.mktemp("ckpt")
    path = str(root / "tiny.pt")
    torch.save(transformers.CLIPModel(cfg).state_dict(), path)
    bpe = root / "merges.txt"
    bpe.write_text("#version: 0.2\n")
    return path, str(bpe)


def _listing(folder):
    return sorted(
        os.path.relpath(os.path.join(d, f), folder) for d, _, files in os.walk(folder) for f in files
    )


def _cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("input_format", ["files", "webdataset"])
def test_port_output_matches_jax_and_indexes(tmp_path, checkpoint, monkeypatch, input_format):
    ckpt, bpe = checkpoint
    monkeypatch.setenv("CRT_BPE_PATH", bpe)
    if input_format == "files":
        dataset = make_files_corpus(str(tmp_path / "corpus"), n=7, with_text=True, with_meta=True)
        wds_n = 10000
    else:
        dataset = make_tar_corpus(str(tmp_path / "tars"), sizes=(4, 3), with_meta=True)
        wds_n = 4
    common = dict(
        input_dataset=dataset,
        input_format=input_format,
        batch_size=4,
        num_prepro_workers=2,
        clip_model=f"test-tiny:{ckpt}",
        enable_metadata=True,
        write_batch_size=4,
        wds_number_file_per_input_file=wds_n,
    )
    out_j, out_t = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    jax_inference(output_folder=out_j, **common)
    torch_inference(output_folder=out_t, device="cpu", **common)

    files = _listing(out_t)
    assert files == _listing(out_j)
    assert "img_emb/img_emb_0.npy" in files and "metadata/metadata_1.parquet" in files
    total = 0
    for rel in files:
        pj, pt = os.path.join(out_j, rel), os.path.join(out_t, rel)
        if rel.endswith(".npy"):
            a, b = np.load(pj), np.load(pt)
            assert a.shape == b.shape and a.dtype == b.dtype == np.float16, rel
            assert _cos(a, b).min() >= MIN_COS, rel
            total += a.shape[0] if rel.startswith("img_emb") else 0
        elif rel.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(pj), pd.read_parquet(pt))
        elif rel.endswith(".json"):
            with open(pj) as fj, open(pt) as ft:
                sj, st = json.load(fj), json.load(ft)
            assert sorted(sj) == sorted(st) and sj["sample_count"] == st["sample_count"], rel
    assert total == 7

    index_folder = str(tmp_path / "index")
    clip_index(out_t, index_folder, index_key="Flat", compute_recall=True)
    with open(index_folder + "/image.json") as f:
        infos = json.load(f)
    assert infos["ntotal"] == 7 and infos["recall@40"] == 1.0


def test_decode_matches_jax_package():
    """Same decoder (native or PIL) behind both packages: identical pixels,
    and a corrupt item is skipped, not fatal."""
    from clip_retrieval_tpu.models import preprocess as jprep
    from clip_retrieval_tpu_torch.models import preprocess as tprep

    from tests.test_inference.fixtures import make_image

    items = [make_image(i, size=(60 + 7 * i, 40)) for i in range(3)] + [b"not an image"]
    got, kept = tprep.decode_batch(items, 32)
    ref, ref_kept = jprep.decode_batch(items, 32)
    assert kept == ref_kept == [0, 1, 2]
    assert got.dtype == np.uint8 and got.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tprep.decode_resize_center_crop(items[1], 32), ref[1])


def test_port_profile_dir_writes_trace_and_op_table(tmp_path, monkeypatch):
    """CRT_PROFILE_DIR records partition 0: a Chrome trace and the
    per-operator table that PERF.md's time breakdown is read from."""
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv("CRT_PROFILE_DIR", str(prof_dir))
    dataset = make_files_corpus(str(tmp_path / "corpus"), n=3)
    out = str(tmp_path / "out")
    torch_inference(
        input_dataset=dataset, output_folder=out, batch_size=2, num_prepro_workers=1, clip_model="test-tiny",
        device="cpu",
    )
    assert "metadata/metadata_0.parquet" in _listing(out)
    with open(prof_dir / "trace_partition0.json") as f:
        assert json.load(f)["traceEvents"]
    table = (prof_dir / "ops_partition0.txt").read_text()
    assert "Self CPU" in table and "aten::mm" in table


def test_port_no_sample_found(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no sample found"):
        torch_inference(input_dataset=str(empty), output_folder=str(tmp_path / "out"), clip_model="test-tiny",
                        device="cpu")

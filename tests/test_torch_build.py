"""The port's index build (`index/build.py`, `index/autotune.py`, the `index`
subcommand) and the tiers it builds, against the JAX package, on the CPU.

- `select_params`/`parse_index_key` agree over a table of corpora, budgets
  and keys;
- `clip_index` on a 5,000×32 corpus (2 shards + metadata) in both packages
  writes headers and infos with the same keys; each folder loads and serves
  in the other package; the port's recall@10 is within 0.05 of the JAX
  build's;
- `ShardedFlatIndex` (flat_int8) matches the JAX tier with exact top-k, and
  `IVFInt8Index.from_vectors` given the same coarse centroids builds
  bit-identical arrays.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from clip_retrieval_tpu.index import autotune as j_auto
from clip_retrieval_tpu.index import build as j_build
from clip_retrieval_tpu.index import store as j_store
from clip_retrieval_tpu.index.ivf_int8 import IVFInt8Index as JIVF
from clip_retrieval_tpu.index.sharded_flat import ShardedFlatIndex as JSF
from clip_retrieval_tpu_torch import cli
from clip_retrieval_tpu_torch.index import autotune as t_auto
from clip_retrieval_tpu_torch.index import build as t_build
from clip_retrieval_tpu_torch.index.ivf_int8 import IVFInt8Index as TIVF
from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex as TPQ
from clip_retrieval_tpu_torch.index.sharded_flat import ShardedFlatIndex as TSF
from clip_retrieval_tpu_torch.index.store import load_index

N, D = 5000, 32
KEY = "OPQ8,IVF32,PQ8,RFlat"


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize(
    "n,d,mem,key",
    [(1000, 32, "4G", None), (200_000, 512, "4G", None), (9_000_000, 768, "100G", None), (50_000_000, 768, "40G", None),
     (100_000_000, 512, "8G", None), (10_000, 96, "1M", None), (5000, 32, "4G", "Flat"), (5000, 32, "4G", "Flat8"),
     (5000, 32, "4G", "IVF64,Flat8,RFlat"), (5000, 32, "4G", KEY), (10**6, 768, "4G", "OPQ64,IVF1024,PQ64,RFlat"),
     (10**6, 768, "4G", "IVF4096,PQ96x8")],
)
def test_select_params_matches_jax(n, d, mem, key):
    got, want = t_auto.select_params(n, d, mem, key), j_auto.select_params(n, d, mem, key)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.index_key == want.index_key
    if key:
        assert dataclasses.asdict(t_auto.parse_index_key(key, d)) == dataclasses.asdict(j_auto.parse_index_key(key, d))


@pytest.mark.parametrize("key", ["PQ64x4,IVF8", "IVF8", "OPQ5,IVF8,PQ5"])
def test_parse_index_key_rejects_like_jax(key):
    with pytest.raises(ValueError) as want:
        j_auto.parse_index_key(key, D)
    with pytest.raises(ValueError) as got:
        t_auto.parse_index_key(key, D)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """An `inference` output folder: img_emb/ in 2 fp16 shards + metadata/."""
    root = tmp_path_factory.mktemp("emb")
    rng = np.random.default_rng(0)
    centers = _unit(rng.normal(size=(64, D)))
    x = _unit(centers[rng.integers(0, 64, N)] + 0.5 * rng.normal(size=(N, D)) / np.sqrt(D)).astype(np.float16)
    os.makedirs(root / "img_emb")
    os.makedirs(root / "metadata")
    np.save(root / "img_emb" / "img_emb_0.npy", x[:3000])
    np.save(root / "img_emb" / "img_emb_1.npy", x[3000:])
    with open(root / "metadata" / "metadata_0.json", "w") as f:
        json.dump({"rows": N}, f)
    return root, x


@pytest.fixture(scope="module")
def built(corpus, tmp_path_factory):
    root, _ = corpus
    out = tmp_path_factory.mktemp("built")
    j_build.clip_index(str(root), str(out / "jax"), index_key=KEY)
    t_build.clip_index(str(root), str(out / "port"), index_key=KEY, device="cpu")
    return out


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_clip_index_artifacts_have_the_same_keys(built):
    for name in ("image.index/header.json", "image.json"):
        j, t = _read(built / "jax" / name), _read(built / "port" / name)
        assert j.keys() == t.keys(), name
    jh, th = _read(built / "jax" / "image.index" / "header.json"), _read(built / "port" / "image.index" / "header.json")
    assert jh["calibration"].keys() == th["calibration"].keys()
    assert {k: jh[k] for k in ("type", "d", "ntotal", "nlist", "m", "ksub", "use_opq", "has_refine")} == \
        {k: th[k] for k in ("type", "d", "ntotal", "nlist", "m", "ksub", "use_opq", "has_refine")}
    assert sorted(os.listdir(built / "jax" / "image.index")) == sorted(os.listdir(built / "port" / "image.index"))
    assert _read(built / "port" / "metadata" / "metadata_0.json") == {"rows": N}
    assert _read(built / "port" / "image.json")["index_key"] == _read(built / "jax" / "image.json")["index_key"]


def test_folders_load_and_serve_in_the_other_package(built, corpus):
    _, x = corpus
    q = x[:5].astype(np.float32)
    port_in_jax = j_store.load_index(str(built / "port" / "image.index"))
    jax_in_port = load_index(str(built / "jax" / "image.index"), device="cpu")
    assert isinstance(jax_in_port, TPQ)
    for ix in (port_in_jax, jax_in_port):
        vals, ids = ix.search(q, 10)
        assert (ids[:, 0] == np.arange(5)).all()  # each stored row finds itself first (exact re-rank)
        assert np.isfinite(vals).all()


def test_port_recall_within_005_of_jax(built, corpus):
    root, _ = corpus
    shards = t_build.EmbeddingShards(str(root / "img_emb"))
    port = load_index(str(built / "port" / "image.index"), device="cpu")
    jax_ix = j_store.load_index(str(built / "jax" / "image.index"))
    r_port = t_build.score_index(port, shards, k=10, device="cpu")["recall@10"]
    r_jax = j_build.score_index(jax_ix, j_build.EmbeddingShards(str(root / "img_emb")), k=10)["recall@10"]
    assert abs(r_port - r_jax) <= 0.05, (r_port, r_jax)
    assert _read(built / "port" / "image.json")["recall@40"] >= 0.9


def test_cli_index_on_cpu(corpus, tmp_path):
    root, x = corpus
    cli.main(["index", "--embeddings_folder", str(root), "--index_folder", str(tmp_path / "ix"), "--index_key",
              "IVF16,Flat8", "--nprobe", "4", "--compute_recall", "False", "--device", "cpu"])
    ix = load_index(str(tmp_path / "ix" / "image.index"), device="cpu")
    assert isinstance(ix, TIVF) and ix.nprobe == 4 and ix.ntotal == N
    assert ix.search(x[:2].astype(np.float32), 5)[1][:, 0].tolist() == [0, 1]


@pytest.mark.parametrize("key", ["Flat", "Flat8"])
def test_exact_tiers_build_alike(corpus, tmp_path, key):
    root, x = corpus
    j_build.clip_index(str(root), str(tmp_path / "j"), index_key=key, compute_recall=False, copy_metadata=False)
    t_build.clip_index(str(root), str(tmp_path / "t"), index_key=key, compute_recall=False, copy_metadata=False,
                       device="cpu")
    assert _read(tmp_path / "j" / "image.index" / "header.json") == _read(tmp_path / "t" / "image.index" / "header.json")
    q = x[100:104].astype(np.float32)
    jx = j_store.load_index(str(tmp_path / "t" / "image.index"))
    if key == "Flat8":
        jx.exact_topk = True
    got = load_index(str(tmp_path / "j" / "image.index"), device="cpu").search(q, 8)
    want = jx.search(q, 8)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)


def test_sharded_flat_matches_jax_exact_topk(corpus):
    _, x = corpus
    xf = x.astype(np.float32)
    q = _unit(np.random.default_rng(1).normal(size=(6, D)))
    jx = JSF.from_vectors(xf)
    jx.exact_topk = True
    tx = TSF.from_vectors(xf, devices=["cpu"])
    np.testing.assert_array_equal(tx.q_vectors, jx.q_vectors)
    got, want = tx.search(q, 10), jx.search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    # k past ntotal pads with -inf / -1; over the whole corpus int8 scores tie,
    # and tied ids may come in either order
    got, want = tx.search(q, N + 3), jx.search(q, N + 3)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert (got[1][:, N:] == -1).all() and all(set(g) == set(w) for g, w in zip(got[1], want[1]))
    np.testing.assert_array_equal(tx.search_and_reconstruct(q, 4)[2], jx.search_and_reconstruct(q, 4)[2])


def test_sharded_flat_scans_in_blocks(corpus, monkeypatch):
    from clip_retrieval_tpu_torch.index import sharded_flat

    _, x = corpus
    q = x[:3].astype(np.float32)
    whole = TSF.from_vectors(x.astype(np.float32), devices=["cpu"]).search(q, 7)
    monkeypatch.setattr(sharded_flat, "BLOCK_ROWS", 700)
    blocked = TSF.from_vectors(x.astype(np.float32), devices=["cpu"]).search(q, 7)
    np.testing.assert_array_equal(blocked[1], whole[1])


@pytest.mark.parametrize("refine", [False, True])
def test_ivf_int8_from_vectors_bit_identical_given_coarse(corpus, refine):
    _, x = corpus
    xf = x.astype(np.float32)
    coarse = _unit(xf[::250][:16])
    j = JIVF.from_vectors(xf, nlist=16, nprobe=4, coarse=coarse, refine=refine, id_offset=7 if not refine else 0)
    t = TIVF.from_vectors(xf, nlist=16, nprobe=4, coarse=coarse, refine=refine, id_offset=7 if not refine else 0,
                          device="cpu")
    for name in ("coarse_centroids", "list_offsets", "list_ids", "q_vectors", "scales"):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)), name)
    if refine:
        np.testing.assert_array_equal(t.refine_vectors, j.refine_vectors)
    with pytest.raises(ValueError, match="do not match"):
        TIVF.from_vectors(xf, nlist=8, coarse=coarse, device="cpu")


def test_ivf_int8_from_vectors_trains_kmeans(corpus):
    _, x = corpus
    t = TIVF.from_vectors(x.astype(np.float32), nlist=16, nprobe=16, seed=0, device="cpu")
    assert t.ntotal == N and t.list_sizes().min() > 0
    q = x[:4].astype(np.float32)
    assert t.search(q, 3)[1][:, 0].tolist() == [0, 1, 2, 3]  # nprobe = nlist: exact up to int8 rounding

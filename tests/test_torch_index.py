"""Port's Flat and IVF-int8 indices against the JAX package's, on the CPU.

The JAX package builds both indices (`FlatIndex`, `IVFInt8Index.from_vectors`
with k-means) from seeded, tie-free unit vectors and saves them (the port's
own `from_vectors` is checked against it too); the port
loads the same directories (device="cpu": K3's plain version scans), and an
index the port saves loads in the JAX package.  Search, search_and_reconstruct,
range_search and the exact re-rank must give identical ids, and scores within
1e-5, in every union mode at b ∈ {1, 3, 8}.  The JAX side runs with
`exact_topk=True`: the port's top-k is always exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from clip_retrieval_tpu.index import ivf_int8 as j_ivf
from clip_retrieval_tpu.index.flat import FlatIndex as JFlat
from clip_retrieval_tpu.index.ivf_int8 import IVFInt8Index as JIVF
from clip_retrieval_tpu_torch.index import ivf_int8 as t_ivf
from clip_retrieval_tpu_torch.index.flat import FlatIndex as TFlat
from clip_retrieval_tpu_torch.index.ivf_int8 import IVFInt8Index as TIVF
from clip_retrieval_tpu_torch.index.store import load_index
from clip_retrieval_tpu_torch.ops import int8scan

N, D, NLIST, NPROBE, K = 2000, 32, 32, 4, 10
ATOL = 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    centers = _unit(rng.normal(size=(NLIST, D)))
    x = _unit(centers[rng.integers(0, NLIST, N)] + 0.3 * rng.normal(size=(N, D)))
    q = _unit(x[rng.choice(N, 8, replace=False)] + 0.05 * rng.normal(size=(8, D)))
    return x, q


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    """Directories the JAX package wrote: flat, ivf_int8, ivf_int8 with refine."""
    x, _ = corpus
    root = tmp_path_factory.mktemp("jax_indices")
    JFlat(D, vectors=x).save(str(root / "flat"))
    JIVF.from_vectors(x, nlist=NLIST, nprobe=NPROBE, seed=0).save(str(root / "ivf"))
    JIVF.from_vectors(x, nlist=NLIST, nprobe=NPROBE, seed=0, refine=True).save(str(root / "ivf_refine"))
    return root


def _jax_ivf(path, union):
    ix = JIVF.load(path)
    ix.union, ix.exact_topk = union, True
    return ix


def _close(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)


def test_flat_cross_load_and_search(saved, corpus, tmp_path):
    x, q = corpus
    jf = JFlat.load(str(saved / "flat"))
    tf = load_index(str(saved / "flat"), device="cpu")
    assert isinstance(tf, TFlat) and tf.ntotal == N
    _close(tf.search(q, K), jf.search(q, K))
    tv, ti, te = tf.search_and_reconstruct(q[:3], 5)
    jv, ji, je = jf.search_and_reconstruct(q[:3], 5)
    _close((tv, ti), (jv, ji))
    np.testing.assert_array_equal(te, je)
    for got, want in zip(tf.range_search(q[:4], 0.9), jf.range_search(q[:4], 0.9)):
        np.testing.assert_array_equal(got, want)
    # the port saves, the JAX package loads
    tf.save(str(tmp_path / "flat"))
    back = JFlat.load(str(tmp_path / "flat"))
    np.testing.assert_array_equal(back.vectors, jf.vectors)


def test_flat_streams_blocks_and_pads_k(corpus, monkeypatch):
    """Blocks smaller than the corpus merge to the one-block answer; k past
    ntotal pads with -inf / -1 like the JAX index."""
    x, q = corpus
    from clip_retrieval_tpu_torch.index import flat as t_flat

    whole = TFlat(D, vectors=x[:300], device="cpu").search(q, K)
    monkeypatch.setattr(t_flat, "_stream_rows", lambda d: 64)  # 5 blocks of ≤ 64 rows
    _close(TFlat(D, vectors=x[:300], device="cpu").search(q, K), whole)
    small = TFlat(D, vectors=x[:4], device="cpu")
    jv, ji = JFlat(D, vectors=x[:4]).search(q, 6)
    tv, ti = small.search(q, 6)
    _close((tv, ti), (jv, ji))
    assert (ti[:, 4:] == -1).all() and np.isneginf(tv[:, 4:]).all()


def test_ivf_cross_load_both_ways(saved, tmp_path):
    jx = JIVF.load(str(saved / "ivf"))
    tx = load_index(str(saved / "ivf"), device="cpu")
    assert isinstance(tx, TIVF) and (tx.ntotal, tx.nlist, tx.nprobe) == (N, NLIST, NPROBE)
    tx.save(str(tmp_path / "ivf"))
    back = JIVF.load(str(tmp_path / "ivf"))
    for name in ("coarse_centroids", "list_offsets", "list_ids", "q_vectors", "scales"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), np.asarray(getattr(jx, name)), name)
    with open(tmp_path / "ivf" / "header.json") as f, open(saved / "ivf" / "header.json") as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("union", ["exact", "static", "device", "auto"])
def test_ivf_search_matches_jax(saved, corpus, union, b):
    _, q = corpus
    path = str(saved / "ivf")
    tx = TIVF.load(path, device="cpu")
    tx.union = union
    jx = _jax_ivf(path, tx.resolve_union(b))  # the JAX route that the port's takes
    _close(tx.search(q[:b], K), jx.search(q[:b], K))
    tv, ti, te = tx.search_and_reconstruct(q[:b], K)
    jv, ji, je = jx.search_and_reconstruct(q[:b], K)
    _close((tv, ti), (jv, ji))
    np.testing.assert_array_equal(te, je)
    assert isinstance(tx.last_union_chunks, int) and tx.last_union_chunks > 0
    # the route of a batch is a function of its padded size; "auto" is exact at every size (the H100 sweep)
    assert tx.resolve_union(1) == ("exact" if union == "auto" else union)
    assert tx.resolve_union(4) == ("exact" if union == "auto" else union)


def test_ivf_rerank_matches_jax(saved, corpus):
    _, q = corpus
    path = str(saved / "ivf_refine")
    jx = _jax_ivf(path, "auto")
    tx = TIVF.load(path, device="cpu")
    assert tx.refine_vectors is not None
    _close(tx.search(q, K), jx.search(q, K))


def test_ivf_static_and_exact_scan_through_k3_plain_version(saved, corpus, monkeypatch):
    """Every route scans through `int8_gather_scan` (here its plain version,
    CPU tensors), once per batch."""
    _, q = corpus
    calls = []
    real = int8scan.int8_gather_scan
    monkeypatch.setattr(t_ivf, "int8_gather_scan", lambda *a: calls.append(a[-1].shape[0]) or real(*a))
    tx = TIVF.load(str(saved / "ivf"), device="cpu")
    tx.search(q[:1], K)  # auto → static
    tx.search(q[:3], K)  # auto → exact
    assert len(calls) == 2


def test_device_mode_overflow_redispatch_is_counted(saved, corpus):
    _, q = corpus
    path = str(saved / "ivf")
    tx = TIVF.load(path, device="cpu")
    tx.union = "device"
    tx._ensure_device()
    tx._dev_caps[(8, NPROBE)] = 1  # a cap below any union: the batch must re-run
    got = tx.search(q, K)
    assert tx.overflow_redispatches == 1
    assert tx._dev_caps[(8, NPROBE)] >= tx.last_union_chunks
    jx = _jax_ivf(path, "device")
    jx._ensure_device()
    jx._dev_caps[(8, NPROBE)] = 1
    _close(got, jx.search(q, K))
    assert jx._dev_caps == tx._dev_caps


def test_chunked_image_matches_jax(saved, monkeypatch):
    tx = TIVF.load(str(saved / "ivf"), device="cpu")
    lc = t_ivf._chunk_len(tx.ntotal, tx.nlist)
    assert lc == j_ivf._chunk_len(tx.ntotal, tx.nlist) == 64
    nc = int((-(-tx.list_sizes() // lc)).sum())
    want = j_ivf.build_chunked_image(tx.q_vectors, tx.scales, tx.list_offsets, lc, pad_chunks=nc + 1)
    tx._ensure_device()
    for name in ("rows", "scales", "pos", "clist"):
        np.testing.assert_array_equal(tx._device[name].numpy(), want[name], name)
    monkeypatch.setattr(t_ivf, "_UPLOAD_ROWS", 100)  # many scatter blocks, one ending mid-list
    part = t_ivf.build_chunked_image(tx.q_vectors, tx.scales, tx.list_offsets, lc, lo=5, hi=9, device="cpu")
    jpart = j_ivf.build_chunked_image(tx.q_vectors, tx.scales, tx.list_offsets, lc, lo=5, hi=9)
    for name in ("rows", "scales", "pos", "clist"):
        np.testing.assert_array_equal(part[name].numpy(), jpart[name], name)


@pytest.mark.parametrize("n", [1, 4, 5, 17, 100, 1000])
def test_bucket_helpers_match_jax(n):
    counts = np.random.default_rng(n).integers(1, 5, 64)
    assert t_ivf._quarter_pow2(n) == j_ivf._quarter_pow2(n)
    assert t_ivf._next_pow2(n) == j_ivf._next_pow2(n)
    assert t_ivf._chunk_len(n * 1000, 64) == j_ivf._chunk_len(n * 1000, 64)
    assert t_ivf.chunk_budget(counts, n) == j_ivf.chunk_budget(counts, n)


def test_empty_index_and_unported_builders(saved, corpus):
    """An empty index answers −inf / −1; `from_vectors`, once unported, now
    builds with the port's k-means and serves like the JAX-built index."""
    empty = TIVF(D, np.zeros((2, D), np.float32), np.zeros(3, np.int64), np.zeros(0, np.int64),
                 np.zeros((0, D), np.int8), np.zeros(0, np.float32), device="cpu")
    vals, ids = empty.search(np.ones((2, D), np.float32), 3)
    assert (ids == -1).all() and np.isneginf(vals).all()
    x, q = corpus
    jx = JIVF.load(str(saved / "ivf"))
    tx = TIVF.from_vectors(x, nlist=NLIST, nprobe=NLIST, seed=0, device="cpu")
    jx.nprobe, jx.exact_topk = NLIST, True  # every list probed: both answers are the exact int8 top-k
    assert (tx.ntotal, tx.nlist) == (N, NLIST)
    _close(tx.search(q, K), jx.search(q, K))


@pytest.mark.parametrize("kind,sharded", [("flat_int8", False), ("ivfpq", False), ("ivf_int8", True)])
def test_load_index_names_the_roadmap_for_unported_tiers(tmp_path, kind, sharded):
    """The sharded IVF tier still names its ROADMAP item; flat_int8 and ivfpq
    are ported now and load as their classes."""
    from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex
    from clip_retrieval_tpu_torch.index.sharded_flat import ShardedFlatIndex

    path = str(tmp_path / "ix")
    if kind == "ivf_int8":
        os.makedirs(path)
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump({"type": kind, "d": D}, f)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            load_index(path, sharded=sharded, device="cpu")
        return
    if kind == "flat_int8":
        ShardedFlatIndex.from_vectors(np.eye(D, dtype=np.float32), device="cpu").save(path)
        want = ShardedFlatIndex
    else:
        IVFPQIndex(D, np.eye(2, D, dtype=np.float32), np.zeros((4, 256, D // 4), np.float32), None,
                   np.array([0, 1, 1]), np.array([5]), np.zeros((1, 4), np.uint8), device="cpu").save(path)
        want = IVFPQIndex
    ix = load_index(path, sharded=sharded, device="cpu")
    assert isinstance(ix, want) and ix.search(np.eye(D, dtype=np.float32)[:1], 1)[1][0, 0] in (0, 5)


def test_readback_is_one_transfer_of_all_parts():
    parts = (torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.tensor([[7, -1]], dtype=torch.int32),
             torch.tensor(5))
    got = t_ivf._readback(*parts)
    for g, p in zip(got, parts):
        np.testing.assert_array_equal(g, p.numpy())

"""Port's IVFPQIndex against the JAX package's, on the CPU.

Both packages get the same arrays (coarse centroids, codebooks, an OPQ-style
rotation, CSR lists of codes and ids, fp16 refine rows).  On the CPU the
JAX index scans with its exact-f32 XLA route (`_scan_device`); the port
scans every device route through K4's plain version.  Ids must be identical
on this tie-free data and scores within 1e-5, on a uniform fixture (the
static chunk-budget route) and a skewed one (the port's static budget, the
JAX package's per-query budget buckets), with k past the candidates, probes
of empty lists and the refine tier.  The host
C++ scan (`_search_host`) is identical in both packages, and folders
cross-load both ways.  Lists are probed by q·c in both packages; one
fixture's centroids have unequal norms, as trained ones do, where that rule
and the k-means filing rule (x·c − ½‖c‖²) pick different lists.
"""

import json

import numpy as np
import pytest
import torch

from clip_retrieval_tpu.index.ivfpq import IVFPQIndex as JPQ
from clip_retrieval_tpu_torch.index import ivfpq as t_ivfpq
from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex as TPQ
from clip_retrieval_tpu_torch.index.store import load_index

D, M, K = 32, 8, 10
ATOL = 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _arrays(sizes, seed, rotate=True, unequal=False):
    rng = np.random.default_rng(seed)
    nlist = len(sizes)
    total = int(sizes.sum())
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    norms = rng.uniform(0.2, 1.5, (nlist, 1)) if unequal else 1.0
    return dict(
        d=D,
        coarse_centroids=(norms * _unit(rng.normal(size=(nlist, D)))).astype(np.float32),
        codebooks=(0.05 * rng.normal(size=(M, 256, D // M))).astype(np.float32),
        rotation=np.linalg.qr(rng.normal(size=(D, D)))[0].astype(np.float32) if rotate else None,
        list_offsets=offsets,
        list_ids=(rng.permutation(total) + 10).astype(np.int64),
        list_codes=rng.integers(0, 256, (total, M)).astype(np.uint8),
    )


@pytest.fixture(scope="module")
def uniform():
    rng = np.random.default_rng(0)
    return _arrays(rng.multinomial(1200, np.full(16, 1 / 16)), seed=1)


@pytest.fixture(scope="module")
def skewed():
    """One giant list (40 chunks), a few mid-size ones, tiny and empty lists:
    both packages take their per-query budget route."""
    sizes = np.full(32, 3, np.int64)
    sizes[0], sizes[[3, 5, 9]], sizes[[1, 7, 12]], sizes[20] = 5000, 130, 0, 1
    return _arrays(sizes, seed=2, rotate=False)


@pytest.fixture(scope="module")
def unequal():
    """Uniform lists under centroids of norms 0.2..1.5: q·c and the filing
    rule q·c − ½‖c‖² rank the lists differently."""
    rng = np.random.default_rng(3)
    return _arrays(rng.multinomial(1200, np.full(16, 1 / 16)), seed=4, unequal=True)


def _pair(arrays, nprobe, refine=None):
    kw = dict(arrays, nprobe=nprobe, refine_vectors=refine)
    return JPQ(**kw), TPQ(**kw, device="cpu")


def _queries(arrays, b, seed):
    rng = np.random.default_rng(seed)
    return _unit(rng.normal(size=(b, D)))


def _close(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("case", ["uniform", "skewed", "unequal"])
def test_search_matches_jax(case, b, request):
    arrays = request.getfixturevalue(case)
    jx, tx = _pair(arrays, nprobe=4)
    q = _queries(arrays, b, seed=b)
    _close(tx.search(q, K), jx.search(q, K))
    tv, ti, te = tx.search_and_reconstruct(q, K)
    jv, ji, je = jx.search_and_reconstruct(q, K)
    _close((tv, ti), (jv, ji))
    np.testing.assert_allclose(te, je, atol=1e-6)


def test_routes_scan_through_k4(uniform, skewed, monkeypatch):
    """A batch within `_STATIC_SLOTS_MAX` score slots takes one static-budget
    dispatch, on uniform and on skewed lists (the H100 route sweep's rule);
    past it, a dispatch per budget bucket, with the same answers.  Every
    dispatch scores through `adc_scan`."""
    calls = []
    real = t_ivfpq.adc_scan
    monkeypatch.setattr(t_ivfpq, "adc_scan", lambda *a: calls.append(a[2].shape[0]) or real(*a))
    _, tx = _pair(uniform, nprobe=4)
    tx.search(_queries(uniform, 5, 0), K)
    assert len(calls) == 1 and calls[0] == 5 * tx._static_nchunk_q(4) == 5 * t_ivfpq._next_pow2(
        max(tx._static_chunk_budget(4), 8))
    calls.clear()
    _, sx = _pair(skewed, nprobe=4)
    q = np.concatenate([skewed["coarse_centroids"][:1], _queries(skewed, 4, 1)])  # one query probes the giant list
    assert sx._budget_route(4, 5) == "static"
    static = sx.search(q, K)
    assert len(calls) == 1
    calls.clear()
    slots = 5 * sx._static_nchunk_q(4) * t_ivfpq._ALIGN
    monkeypatch.setattr(t_ivfpq, "_STATIC_SLOTS_MAX", slots - 1)
    assert sx._budget_route(4, 5) == "buckets" and sx._budget_route(4, 4) == "static"
    buckets = sx.search(q, K)
    assert len(calls) >= 2
    _close(buckets, static)


def test_k_past_candidates_and_empty_lists(skewed):
    jx, tx = _pair(skewed, nprobe=1)
    q = skewed["coarse_centroids"][[20]]  # the one-row list
    got, want = tx.search(q, 8), jx.search(q, 8)
    _close(got, want)
    assert (got[1][0] >= 0).sum() == 1 and (got[1][0, 1:] == -1).all()
    q = skewed["coarse_centroids"][[7]]  # an empty list
    got, want = tx.search(q, 4), jx.search(q, 4)
    _close(got, want)
    assert (got[1] == -1).all() and np.isneginf(got[0]).all()


def test_refine_matches_jax(uniform):
    rng = np.random.default_rng(5)
    refine = rng.normal(size=(int(uniform["list_offsets"][-1]) + 10, D)).astype(np.float16)
    jx, tx = _pair(uniform, nprobe=6, refine=refine)
    q = _queries(uniform, 4, 6)
    _close(tx.search(q, K), jx.search(q, K))


@pytest.mark.parametrize("case", ["uniform", "skewed", "unequal"])
def test_host_scan_identical_to_jax(case, request, monkeypatch):
    arrays = request.getfixturevalue(case)
    jx, tx = _pair(arrays, nprobe=5)
    q = _queries(arrays, 6, 9)
    got, want = tx._search_host(q, K, 5), jx._search_host(q, K, 5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # codes that do not fit the device's free memory take the host route
    monkeypatch.setattr(t_ivfpq, "_device_room", lambda device: 0)
    vals, ids = tx.search(q, K)
    np.testing.assert_array_equal(ids, jx._search_host(q, K, 5)[1])


@pytest.mark.parametrize("case", ["uniform", "unequal"])
def test_device_and_host_routes_agree(case, request):
    arrays = request.getfixturevalue(case)
    _, tx = _pair(arrays, nprobe=4)
    q = _queries(arrays, 8, 3)
    dv, di = tx._search_device(q, K, 4)
    hv, hi = tx._search_host(q, K, 4)
    np.testing.assert_array_equal(di, hi)  # tie-free data: the summation order does not reorder ids
    np.testing.assert_allclose(dv, hv, atol=1e-5)


def test_folders_cross_load_both_ways(uniform, tmp_path):
    rng = np.random.default_rng(7)
    refine = rng.normal(size=(int(uniform["list_offsets"][-1]) + 10, D)).astype(np.float16)
    jx, tx = _pair(uniform, nprobe=3, refine=refine)
    tx.save(str(tmp_path / "t"))
    jx.save(str(tmp_path / "j"))
    with open(tmp_path / "t" / "header.json") as f, open(tmp_path / "j" / "header.json") as g:
        assert json.load(f) == json.load(g)
    back = JPQ.load(str(tmp_path / "t"))
    for name in ("coarse_centroids", "codebooks", "rotation", "list_offsets", "list_ids", "list_codes",
                 "refine_vectors"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), np.asarray(getattr(jx, name)), name)
    loaded = load_index(str(tmp_path / "j"), device="cpu")
    assert isinstance(loaded, TPQ) and (loaded.nprobe, loaded.rerank_factor) == (3, 4)
    q = _queries(uniform, 3, 8)
    _close(loaded.search(q, K), jx.search(q, K))


def test_reconstruct_raises_on_unknown_ids(uniform):
    _, tx = _pair(uniform, nprobe=2)
    with pytest.raises(KeyError, match="not in index"):
        tx.reconstruct_batch(np.array([3]))  # ids start at 10
    empty = TPQ(D, uniform["coarse_centroids"], uniform["codebooks"], None, np.zeros(17, np.int64),
                np.zeros(0, np.int64), np.zeros((0, M), np.uint8), device="cpu")
    vals, ids = empty.search(np.ones((2, D), np.float32), 3)
    assert (ids == -1).all() and np.isneginf(vals).all()


def test_budget_buckets_and_device_image(uniform):
    from clip_retrieval_tpu.index import ivfpq as j_ivfpq

    totals = np.array([1, 9, 8, 33, 100, 7])
    got, want = t_ivfpq._budget_buckets(totals, 8), j_ivfpq._budget_buckets(totals, 8)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    jx, tx = _pair(uniform, nprobe=2)
    jx._build_device()
    dv = tx._ensure_device()
    np.testing.assert_array_equal(dv["codes"].numpy(), np.asarray(jx._device["flat_codes"]))
    np.testing.assert_array_equal(dv["astarts"].numpy(), np.asarray(jx._device["astarts"]))
    assert tx._ensure_device() is dv and tx.pq.codebooks.dtype == torch.float32


def test_probe_is_top_qc_as_in_jax():
    """Both packages probe the top q·c lists, not the list k-means filed a
    row in (argmax x·c − ½‖c‖²): with a short centroid beside a long one,
    a stored row is missed by both alike at nprobe 1 and found at nprobe 2."""
    x = _unit(np.array([[1.0, 0.2] + [0.0] * (D - 2)]))
    coarse = np.zeros((2, D), np.float32)
    coarse[0, :2] = [0.5, 0.1]  # close to x, short: x's list by assignment
    coarse[1, :2] = [1.2, -1.0]  # long: first by q·c alone
    assert np.argmax(x @ coarse.T - 0.5 * (coarse**2).sum(1)) == 0 and np.argmax(x @ coarse.T) == 1
    arrays = dict(d=D, coarse_centroids=coarse, codebooks=np.zeros((M, 256, D // M), np.float32), rotation=None,
                  list_offsets=np.array([0, 1, 1]), list_ids=np.array([7]), list_codes=np.zeros((1, M), np.uint8))
    for nprobe, want in ((1, -1), (2, 7)):
        jx, tx = _pair(arrays, nprobe=nprobe)
        assert tx.search(x, 1)[1][0, 0] == tx._search_host(x, 1, nprobe)[1][0, 0] == jx.search(x, 1)[1][0, 0] == want

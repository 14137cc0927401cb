"""The list-sharded IVF-int8 tier of the port (`index/sharded_ivf.py`) on the
CPU, over devices=["cpu"] * n, n ∈ {1, 2, 4}.

The first thirteen tests mirror tests/test_index/test_sharded_ivf.py case by
case (recall at least the one-device tier's, true int8 scores, uneven nlist,
k past ntotal, empty index, load dispatch, mid-scale recall with refine,
lists that cannot steal probes, and the exact/static/auto/device union
routes with the device route's overflow).  Then the tier is held to the JAX
package's `ShardedIVFInt8Index` on the same index over a mesh of n of the
conftest's 8 virtual CPU devices, with `exact_topk=True`, on tie-free data:
identical ids and scores within 1e-5 on every route (the device route at
full probe, where its budget fill cannot differ), a folder written by either
package loads in the other, and the per-shard scan is K3 (one call per
shard per batch).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from clip_retrieval_tpu.index.ivf_int8 import IVFInt8Index as JIVF
from clip_retrieval_tpu.index.sharded_ivf import ShardedIVFInt8Index as JSharded
from clip_retrieval_tpu.index.store import load_index as jax_load_index
from clip_retrieval_tpu_torch.index import ivf_int8 as t_ivf
from clip_retrieval_tpu_torch.index.flat import FlatIndex
from clip_retrieval_tpu_torch.index.ivf_int8 import IVFInt8Index
from clip_retrieval_tpu_torch.index.sharded_ivf import ShardedIVFInt8Index
from clip_retrieval_tpu_torch.index.store import load_index

NS = [1, 2, 4]
ATOL = 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _cpus(n):
    return ["cpu"] * n


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    centers = _unit(rng.normal(size=(32, 64)))
    x = centers[rng.integers(0, 32, 4000)] + 0.15 * rng.normal(size=(4000, 64))
    return _unit(x)


@pytest.fixture(scope="module")
def single(corpus):
    return IVFInt8Index.from_vectors(corpus, nlist=64, nprobe=16, seed=0, device="cpu")


def _sharded(single, n, **attrs):
    ix = ShardedIVFInt8Index.from_index(single, devices=_cpus(n))
    for k, v in attrs.items():
        setattr(ix, k, v)
    return ix


def _recall(gt, got):
    return np.mean([len(set(gt[i]) & set(got[i])) / gt.shape[1] for i in range(gt.shape[0])])


def _flat(x):
    exact = FlatIndex(x.shape[1], device="cpu")
    exact.add(x)
    return exact


# -- the JAX tier's cases ------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_recall_at_least_single_chip(corpus, single, n):
    q = corpus[:40]
    _, gt = _flat(corpus).search(q, 10)
    _, got_1 = single.search(q, 10)
    _, got_n = _sharded(single, n).search(q, 10)
    r1, rn = _recall(gt, got_1), _recall(gt, got_n)
    assert rn >= r1 - 1e-9, (rn, r1)  # per-shard probing unions ⊇ the one-device probe set
    assert rn >= 0.9, rn
    assert (got_n[:, 0] == np.arange(len(q))).all()


@pytest.mark.parametrize("n", NS)
def test_scores_are_true_int8_products(corpus, single, n):
    q = corpus[:8]
    ix = _sharded(single, n)
    vals, ids = ix.search(q, 5)
    assert (ids >= 0).all()
    recon = ix.reconstruct_batch(ids.reshape(-1)).reshape(8, 5, 64)
    np.testing.assert_allclose(vals, np.einsum("bd,bkd->bk", q, recon), atol=0.05)
    assert (np.diff(vals, axis=1) <= 1e-6).all()


@pytest.mark.parametrize("n", NS)
def test_uneven_nlist_pads_across_shards(corpus, n):
    # nlist=10 over 4 devices: shards of 3, 3, 3 and 1 lists
    ix = ShardedIVFInt8Index.from_vectors(corpus[:500], nlist=10, nprobe=4, seed=1, devices=_cpus(n))
    vals, ids = ix.search(corpus[:6], 8)
    assert ids.shape == (6, 8)
    assert (ids[np.isfinite(vals)] >= 0).all() and (ids[np.isfinite(vals)] < 500).all()
    assert (ids[:, 0] == np.arange(6)).all()


@pytest.mark.parametrize("n", NS)
def test_k_larger_than_ntotal(corpus, n):
    ix = ShardedIVFInt8Index.from_vectors(corpus[:30], nlist=4, nprobe=4, devices=_cpus(n))
    vals, ids = ix.search(corpus[:3], 50)
    assert ids.shape == (3, 50)
    for row_ids, row_vals in zip(ids, vals):
        found = row_ids[np.isfinite(row_vals)]
        assert len(np.unique(found)) == len(found)  # no duplicates per query


@pytest.mark.parametrize("n", NS)
def test_empty_index(n):
    ix = ShardedIVFInt8Index(8, np.zeros((2, 8), np.float32), np.zeros(3, np.int64), np.zeros((0,), np.int64),
                             np.zeros((0, 8), np.int8), np.zeros((0,), np.float32), devices=_cpus(n))
    vals, ids = ix.search(np.zeros((2, 8), np.float32), 4)
    assert (ids == -1).all() and not np.isfinite(vals).any()


@pytest.mark.parametrize("n", NS)
def test_load_dispatch_and_roundtrip(tmp_path, corpus, single, n):
    p = str(tmp_path / "ix")
    single.save(p)
    assert type(load_index(p, device="cpu")) is IVFInt8Index
    back = load_index(p, sharded=True, device="cpu", devices=_cpus(n))
    assert isinstance(back, ShardedIVFInt8Index) and len(back.devices) == n
    q = corpus[:10]
    v0, i0 = _sharded(single, n).search(q, 5)
    v1, i1 = back.search(q, 5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(v0, v1, atol=ATOL)


def test_env_switch_loads_the_sharded_tier(tmp_path, single, monkeypatch):
    p = str(tmp_path / "ix")
    single.save(p)
    monkeypatch.setenv("CRT_SHARDED_IVF", "1")
    assert isinstance(load_index(p, device="cpu"), ShardedIVFInt8Index)


@pytest.mark.parametrize("n", NS)
def test_midscale_recall_on_virtual_mesh(n):
    """120k×64 clustered corpus over n devices, refine tier on: 6.25 % scan
    (nprobe 32 / nlist 512) plus the exact re-rank reaches the serving
    recall target."""
    rng = np.random.default_rng(7)
    rows, d, nc = 120_000, 64, 1500
    centers = _unit(rng.normal(size=(nc, d)))
    x = _unit(centers[np.arange(rows) % nc] + 0.25 * rng.normal(size=(rows, d)).astype(np.float32))
    ix = ShardedIVFInt8Index.from_vectors(x, nlist=512, nprobe=32, kmeans_niter=4, seed=0, refine=True,
                                          devices=_cpus(n))
    q = _unit(centers[rng.integers(0, nc, 64)] + 0.25 * rng.normal(size=(64, d)).astype(np.float32))
    _, gt = _flat(x).search(q, 10)
    _, got = ix.search(q, 10)
    assert _recall(gt, got) >= 0.95
    assert (got >= 0).all() and (got < rows).all()


@pytest.mark.parametrize("n", NS)
def test_padding_lists_never_steal_probes(n):
    """nlist=13 does not divide over 4 devices; queries anti-aligned with the
    centroid mean must still probe their own lists."""
    rng = np.random.default_rng(3)
    d = 32
    pos = _unit(np.abs(rng.normal(size=(3000, d))) + 0.5)
    neg = np.zeros((200, d), np.float32)
    neg[:, 0] = -1.0
    neg = _unit(neg + 0.05 * rng.normal(size=(200, d)).astype(np.float32))
    x = np.concatenate([pos, neg]).astype(np.float32)
    single = IVFInt8Index.from_vectors(x, nlist=13, nprobe=4, seed=0, device="cpu")
    sharded = ShardedIVFInt8Index.from_index(single, devices=_cpus(n))
    q = x[3000:3040]
    _, got_1 = single.search(q, 5)
    _, got_s = sharded.search(q, 5)
    for i in range(q.shape[0]):
        hits_1, hits_s = set(got_1[i][got_1[i] >= 0]), set(got_s[i][got_s[i] >= 0])
        assert got_s[i][0] == 3000 + i
        assert len(hits_s & hits_1) >= len(hits_1) - 1


@pytest.mark.parametrize("n", NS)
def test_sharded_exact_union_matches_static(corpus, single, n):
    ex, st = _sharded(single, n, union="exact"), _sharded(single, n, union="static")
    q = _unit(np.random.default_rng(3).normal(size=(9, 64)))
    ex.nprobe = st.nprobe = 64  # all lists → both routes are int8-exact
    v_ex, i_ex = ex.search(q, 10)
    v_st, i_st = st.search(q, 10)
    np.testing.assert_array_equal(i_ex, i_st)
    np.testing.assert_allclose(v_ex, v_st, rtol=1e-5)
    ex.nprobe = st.nprobe = 8  # partial probing: static's budget fill can only add candidates
    v_ex, i_ex = ex.search(q, 10)
    v_st, _ = st.search(q, 10)
    assert (v_ex <= v_st + 1e-5).all()
    for row in i_ex:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


@pytest.mark.parametrize("n", NS)
def test_sharded_exact_union_recall_at_least_per_query(corpus, single, n):
    q = _unit(np.random.default_rng(5).normal(size=(16, 64)))
    _, gt = _flat(corpus).search(q, 10)
    _, got = _sharded(single, n, union="exact", nprobe=16).search(q, 10)
    _, got1 = single.search(q, 10)
    assert _recall(gt, got) >= _recall(gt, got1) - 1e-9


@pytest.mark.parametrize("n", NS)
def test_sharded_union_auto_routes_per_batch(corpus, single, n):
    """auto takes the measured route, exact, at B=1 and B>1 (the JAX tier
    takes static at B=1); the route rides in the dispatch handle."""
    au, ex = _sharded(single, n, union="auto"), _sharded(single, n, union="exact")
    q = _unit(np.random.default_rng(7).normal(size=(8, 64)))
    for qb in (q[:1], q):
        assert au._search_int8_dispatch(qb, 5)["mode"] == "exact"
        va, ia = au.search(qb, 5)
        ve, ie = ex.search(qb, 5)
        np.testing.assert_array_equal(ia, ie)
        np.testing.assert_allclose(va, ve, rtol=1e-5)
    assert not hasattr(au, "_last_union_resolved")


@pytest.mark.parametrize("n", NS)
def test_sharded_device_union_matches_exact(corpus, single, n):
    q = corpus[:24]
    dv, ex = _sharded(single, n, union="device", nprobe=64), _sharded(single, n, union="exact", nprobe=64)
    v_dv, i_dv = dv.search(q, 10)
    v_ex, i_ex = ex.search(q, 10)
    np.testing.assert_array_equal(i_dv, i_ex)
    np.testing.assert_allclose(v_dv, v_ex, rtol=1e-5)
    assert dv.overflow_redispatches == 0
    assert type(dv.last_union_chunks) is int and type(ex.last_union_chunks) is int
    assert dv.last_union_chunks == ex.last_union_chunks  # the largest per-shard union, either route


@pytest.mark.parametrize("n", NS)
def test_sharded_device_union_overflow_grows_cap(corpus, single, n):
    q = corpus[:24]
    dv, ref = _sharded(single, n, union="device", nprobe=16), _sharded(single, n, union="device", nprobe=16)
    dv._ensure_device()
    dv._dev_caps[(32, 16)] = 1  # 24 queries pad to 32; force the overflow
    v_dv, i_dv = dv.search(q, 10)
    assert dv._dev_caps[(32, 16)] >= dv.last_union_chunks > 1
    assert dv.overflow_redispatches == 1 and ref.overflow_redispatches == 0
    v_ref, i_ref = ref.search(q, 10)
    np.testing.assert_array_equal(i_dv, i_ref)
    np.testing.assert_allclose(v_dv, v_ref, rtol=1e-5)


# -- against the JAX tier --------------------------------------------------------


@pytest.fixture(scope="module")
def tie_free():
    """Gaussian rows: no two int8 scores of a query tie."""
    rng = np.random.default_rng(11)
    x = _unit(rng.normal(size=(3000, 64)))
    q = _unit(rng.normal(size=(6, 64)))
    return IVFInt8Index.from_vectors(x, nlist=37, nprobe=5, seed=0, device="cpu"), q


def _jax_twin(ix: IVFInt8Index, n: int, union: str, nprobe: int):
    j = JIVF(ix.d, ix.coarse_centroids, ix.list_offsets, np.asarray(ix.list_ids), np.asarray(ix.q_vectors),
             np.asarray(ix.scales), nprobe=nprobe, exact_topk=True, union=union)
    return JSharded.from_index(j, mesh=Mesh(np.array(jax.devices()[:n]), ("dp",)))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("union,nprobe", [("exact", 5), ("exact", 37), ("static", 5), ("static", 37),
                                          ("device", 37)])
def test_ids_match_jax_sharded_tier(tie_free, n, union, nprobe):
    ix, q = tie_free
    t = _sharded(ix, n, union=union, nprobe=nprobe)
    j = _jax_twin(ix, n, union, nprobe)
    j.union = union
    for qb in (q[:1], q):
        got, want = t.search(qb, 12), j.search(qb, 12)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_folders_cross_load_between_packages(tie_free, tmp_path, n):
    ix, q = tie_free
    ix.save(str(tmp_path / "torch"))
    _jax_twin(ix, n, "exact", 5).save(str(tmp_path / "jax"))
    t = load_index(str(tmp_path / "jax"), sharded=True, device="cpu", devices=_cpus(n))
    j = jax_load_index(str(tmp_path / "torch"), sharded=True)
    assert isinstance(t, ShardedIVFInt8Index) and isinstance(j, JSharded)
    j.union, j.exact_topk, t.union = "exact", True, "exact"
    got, want = t.search(q, 10), j.search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


@pytest.mark.parametrize("union", ["exact", "device", "static"])
def test_each_shard_scans_through_k3_once_per_batch(tie_free, monkeypatch, union):
    ix, q = tie_free
    calls = []
    real = t_ivf.int8_gather_scan

    def counting(*args):
        calls.append(args[-1].shape[0])  # chunks selected on this shard
        return real(*args)

    monkeypatch.setattr(t_ivf, "int8_gather_scan", counting)
    sh = _sharded(ix, 4, union=union)
    sh.search(q, 10)
    assert len(calls) == len(sh._shards) == 4

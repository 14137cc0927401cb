"""Port's k-means and PQ/OPQ against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages.  `jax.random` cannot
be reproduced, so the Lloyd loop is held to the JAX `_kmeans_jit` given the
same initial centroids (centroids atol 1e-5, identical assignments, on
well-separated blobs, with the empty-cluster re-seed and all-zero rows);
k-means++ and the full trainers are checked for what they must deliver.
PQ: codes identical, decode/reconstruct atol 1e-6, ADC tables rtol/atol
1e-5, the Procrustes rotation to 1e-4 given the same x and x̂, OPQ's
rotation orthogonal to 1e-4 and its quantization error no worse than PQ's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_retrieval_tpu.ops import kmeans as j_km
from clip_retrieval_tpu.ops import pq as j_pq
from clip_retrieval_tpu_torch.ops import kmeans as t_km
from clip_retrieval_tpu_torch.ops import pq as t_pq


def _blobs(k=6, d=8, per=50, seed=0, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 3.0
    x = (centers[np.repeat(np.arange(k), per)] + spread * rng.normal(size=(k * per, d))).astype(np.float32)
    return x[rng.permutation(len(x))], centers


def _jax_lloyd(x, init, niter, chunk=128):
    """The JAX loop on x laid out as its zero-padded (C, chunk, d) chunks."""
    n, d = x.shape
    c = -(-n // chunk)
    xc = np.zeros((c * chunk, d), np.float32)
    xc[:n] = x
    k = init.shape[0]
    return np.asarray(j_km._kmeans_jit(jnp.asarray(xc.reshape(c, chunk, d)), jnp.asarray(init), k, niter))


def _check_lloyd(x, init, niter=6):
    want = _jax_lloyd(x, init, niter)
    got = t_km.lloyd(torch.from_numpy(x), torch.from_numpy(init), niter).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ja = j_km.assign_chunked(x, jnp.asarray(want))
    ta = t_km.assign_chunked(x, torch.from_numpy(got))
    np.testing.assert_array_equal(ta, ja)
    return got


def test_lloyd_matches_jax_on_blobs():
    x, centers = _blobs()
    init = x[:6].copy()  # the first rows: several blobs seeded twice, some not at all
    got = _check_lloyd(x, init)
    assert got.shape == (6, 8)


def test_lloyd_reseeds_an_empty_cluster_like_jax():
    x, centers = _blobs(k=4, per=40, seed=1)
    init = np.concatenate([centers[:3], np.full((2, 8), 100.0, np.float32)])  # two seeds nobody joins
    got = _check_lloyd(x, init, niter=4)
    assert np.abs(got).max() < 50  # both far seeds were re-seeded from the largest cluster


def test_lloyd_zero_rows_do_not_vote():
    x, centers = _blobs(k=3, per=30, seed=2)
    x = np.concatenate([x, np.zeros((25, 8), np.float32)])  # explicit all-zero rows, not padding
    init = centers + 0.5
    got = _check_lloyd(x, init, niter=3)
    # with the zero rows voting, some centroid would be pulled towards the origin
    np.testing.assert_allclose(got, _check_lloyd(x[:-25], init, niter=3), atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("chunk", [None, 37])
def test_assign_chunked_ids_identical(dtype, chunk):
    x, centers = _blobs(k=16, d=12, per=20, seed=3, spread=0.5)
    x = x.astype(dtype)
    want = j_km.assign_chunked(x, jnp.asarray(centers), chunk=chunk)
    got = t_km.assign_chunked(x, torch.from_numpy(centers), chunk=chunk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_kmeanspp_init_draws_distinct_rows():
    x, _ = _blobs(k=5, per=40, seed=4)
    gen = torch.Generator().manual_seed(0)
    init = t_km.kmeanspp_init(torch.from_numpy(x), 5, gen).numpy()
    rows = {tuple(r) for r in x}
    assert all(tuple(r) in rows for r in init)
    assert len({tuple(r) for r in init}) == 5
    multi = t_km.kmeanspp_init(torch.from_numpy(np.stack([x, -x])), 5, gen)
    assert multi.shape == (2, 5, 8)


def test_kmeans_recovers_blobs_and_subsamples():
    x, centers = _blobs(k=6, per=80, seed=5)
    cent = t_km.kmeans(x, 6, niter=10, seed=0, max_points=300, device="cpu").numpy()
    dist = np.linalg.norm(centers[:, None] - cent[None], axis=-1).min(1)
    assert dist.max() < 0.1, dist
    few = t_km.kmeans(x[:4], 6, niter=2, device="cpu")  # n < k: rows repeat, as in JAX
    assert few.shape == (6, 8) and torch.isfinite(few).all()


def test_kmeans_multi_trains_each_subspace():
    x0, c0 = _blobs(k=4, d=3, per=40, seed=6)
    x1, c1 = _blobs(k=4, d=3, per=40, seed=7)
    cb = t_km.kmeans_multi(np.stack([x0, x1]), 4, niter=10, device="cpu").numpy()
    for cent, true in ((cb[0], c0), (cb[1], c1)):
        assert np.linalg.norm(true[:, None] - cent[None], axis=-1).min(1).max() < 0.1


def _pq_case(seed=0, n=200, d=16, m=4, ksub=16, rotate=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    cb = rng.normal(size=(m, ksub, d // m)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32) if rotate else None
    jpq = j_pq.PQCodebooks(jnp.asarray(cb), None if rot is None else jnp.asarray(rot))
    tpq = t_pq.PQCodebooks(torch.from_numpy(cb), None if rot is None else torch.from_numpy(rot))
    return x, jpq, tpq


@pytest.mark.parametrize("rotate", [False, True])
def test_pq_encode_decode_reconstruct_match_jax(rotate):
    x, jpq, tpq = _pq_case(rotate=rotate)
    codes = t_pq.pq_encode(x, tpq, chunk=64)
    np.testing.assert_array_equal(codes, j_pq.pq_encode(x, jpq, chunk=64))
    dec = t_pq.pq_decode(torch.from_numpy(codes), tpq.codebooks).numpy()
    np.testing.assert_allclose(dec, np.asarray(j_pq.pq_decode(jnp.asarray(codes), jpq.codebooks)), atol=1e-6)
    rec = t_pq.pq_reconstruct(codes, tpq).numpy()
    np.testing.assert_allclose(rec, np.asarray(j_pq.pq_reconstruct(codes, jpq)), atol=1e-6)


def test_adc_lut_and_score_match_jax():
    x, jpq, tpq = _pq_case(seed=1)
    q = x[:5]
    codes = t_pq.pq_encode(x, tpq)
    lut = t_pq.adc_lut(torch.from_numpy(q), tpq.codebooks)
    jlut = j_pq.adc_lut(jnp.asarray(q), jpq.codebooks)
    np.testing.assert_allclose(lut.numpy(), np.asarray(jlut), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_pq.adc_score(lut, torch.from_numpy(codes)).numpy(),
                               np.asarray(j_pq.adc_score(jlut, jnp.asarray(codes))), rtol=1e-5, atol=1e-5)


def test_procrustes_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    xhat = (x @ np.linalg.qr(rng.normal(size=(16, 16)))[0] + 0.1 * rng.normal(size=(300, 16))).astype(np.float32)
    # the JAX package's step (ops/pq.py, train_opq): R = UVᵀ from svd(xᵀ·x̂)
    u, _, vt = jnp.linalg.svd(jnp.dot(jnp.asarray(x).T, jnp.asarray(xhat)), full_matrices=False)
    want = np.asarray(jnp.dot(u, vt))
    got = t_pq.procrustes(torch.from_numpy(x), torch.from_numpy(xhat)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _quant_error(x, pq):
    rec = t_pq.pq_reconstruct(t_pq.pq_encode(x, pq), pq).numpy()
    return float(np.mean(np.sum((x - rec) ** 2, axis=1)))


def test_opq_rotation_is_orthogonal_and_no_worse_than_pq():
    rng = np.random.default_rng(3)
    # correlated, anisotropic dims: the case a rotation helps
    x = (rng.normal(size=(1500, 16)) * np.linspace(3.0, 0.2, 16)) @ np.linalg.qr(rng.normal(size=(16, 16)))[0]
    x = x.astype(np.float32)
    opq = t_pq.train_opq(x, 4, 16, opq_iters=4, pq_niter=8, seed=0, device="cpu")
    r = opq.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(16), atol=1e-4)
    plain = t_pq.train_pq(x, 4, 16, niter=8, seed=0, device="cpu")
    assert _quant_error(x, opq) <= _quant_error(x, plain)
    with pytest.raises(ValueError, match="not divisible"):
        t_pq.train_pq(x, 5, 16, device="cpu")

"""The multi-device `ShardedFlatIndex` (flat_int8) against the JAX tier, on the
CPU: rows split over devices=["cpu"] * n as the JAX tier splits them over a
mesh of n of the conftest's 8 virtual CPU devices (exact top-k), for n not
dividing the row count and for k past it.  Ids must be identical on tie-free
data and scores within 1e-5 (two f32 rescalings of one exact int8 product).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from clip_retrieval_tpu.index.sharded_flat import ShardedFlatIndex as JSF
from clip_retrieval_tpu_torch.index import sharded_flat
from clip_retrieval_tpu_torch.index.sharded_flat import ShardedFlatIndex as TSF
from clip_retrieval_tpu_torch.index.store import load_index

D = 64
ATOL = 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _unit(rng.normal(size=(1003, D)))  # 1003 rows: no n in {2, 3, 4, 8} divides it


def _jax(x, n):
    ix = JSF.from_vectors(x, mesh=Mesh(np.array(jax.devices()[:n]), ("dp",)))
    ix.exact_topk = True
    return ix


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_ids_match_jax_over_n_devices(corpus, n):
    q = _unit(np.random.default_rng(1).normal(size=(7, D)))
    t, j = TSF.from_vectors(corpus, devices=["cpu"] * n), _jax(corpus, n)
    got, want = t.search(q, 10), j.search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    assert len(t._ensure_device()) == n and sum(s[2].shape[0] for s in t._shards) == corpus.shape[0]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_k_past_ntotal_pads_like_jax(n):
    x = _unit(np.random.default_rng(2).normal(size=(5, 16)))  # 5 rows: some of the 8 shards hold none
    t, j = TSF.from_vectors(x, devices=["cpu"] * n), _jax(x, n)
    got, want = t.search(x[:2], 12), j.search(x[:2], 12)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    assert (got[1][:, 5:] == -1).all() and np.isneginf(got[0][:, 5:]).all()
    assert (got[1][:, 0] == [0, 1]).all()


def test_blocks_within_a_shard_and_reconstruct(corpus, monkeypatch):
    q = corpus[:5]
    whole = TSF.from_vectors(corpus, devices=["cpu"] * 3)
    want = whole.search(q, 9)
    monkeypatch.setattr(sharded_flat, "BLOCK_ROWS", 100)  # 335-row shards in 4 blocks each
    blocked = TSF.from_vectors(corpus, devices=["cpu"] * 3)
    got = blocked.search(q, 9)
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][:, 0] == np.arange(5)).all()
    _, ids, recon = blocked.search_and_reconstruct(q, 4)
    np.testing.assert_array_equal(recon, _jax(corpus, 3).search_and_reconstruct(q, 4)[2])


def test_folders_cross_load_and_shard_over_the_devices_given(corpus, tmp_path):
    q = corpus[:3]
    _jax(corpus, 4).save(str(tmp_path / "j"))
    TSF.from_vectors(corpus, devices=["cpu"]).save(str(tmp_path / "t"))
    from clip_retrieval_tpu.index.store import load_index as jax_load

    t = load_index(str(tmp_path / "j"), device="cpu", devices=["cpu"] * 4)
    j = jax_load(str(tmp_path / "t"))
    j.exact_topk = True
    assert isinstance(t, TSF) and [d.type for d in t.devices] == ["cpu"] * 4
    np.testing.assert_array_equal(t.search(q, 5)[1], j.search(q, 5)[1])
    # without devices, a CPU `device` is the one device
    assert [d.type for d in load_index(str(tmp_path / "t"), device="cpu").devices] == ["cpu"]

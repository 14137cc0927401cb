"""The port's `index/combiner.py` against the JAX package's, on the CPU.

Shards share one trained prefix (coarse centroids; for IVF-PQ also the
codebooks and an OPQ-style rotation) and split seeded, tie-free unit vectors
by id range.  Each package combines its own shard objects built from the
same arrays: the merged arrays must be equal, the merged folders written by
the two `index_combiner` entry points byte-equal and loadable in either
package, and the merged index searched in each package must return
identical ids (the port on the CPU, K3's and K4's plain versions).  The two
refine-drop warnings fire in both packages, and a merged index whose ids do
not tile 0..N-1 drops its refine tier and cannot be IVF-reordered in either.
"""

import json
import os

import numpy as np
import pytest

from clip_retrieval_tpu.index import combiner as j_comb
from clip_retrieval_tpu.index import metadata_order as j_order
from clip_retrieval_tpu.index.ivf_int8 import IVFInt8Index as JIVF
from clip_retrieval_tpu.index.ivfpq import IVFPQIndex as JPQ
from clip_retrieval_tpu.index.store import load_index as j_load
from clip_retrieval_tpu_torch.index import combiner as t_comb
from clip_retrieval_tpu_torch.index import metadata_order as t_order
from clip_retrieval_tpu_torch.index.ivf_int8 import IVFInt8Index as TIVF
from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex as TPQ
from clip_retrieval_tpu_torch.index.store import load_index as t_load

N, D, NLIST, M, K = 3000, 32, 16, 8, 10
SPLIT = (0, 1000, 1800, N)  # three shards, unequal


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = _unit(rng.normal(size=(NLIST, D)))
    x = _unit(centers[rng.integers(0, NLIST, N)] + 0.3 * rng.normal(size=(N, D)))
    q = _unit(x[rng.choice(N, 8, replace=False)] + 0.05 * rng.normal(size=(8, D)))
    return {
        "x": x,
        "q": q,
        "coarse": centers,
        "codebooks": (0.1 * rng.normal(size=(M, 256, D // M))).astype(np.float32),
        "rotation": np.linalg.qr(rng.normal(size=(D, D)))[0].astype(np.float32),
    }


def _pq_shard_arrays(data, lo, hi, id_offset, refine):
    """The CSR arrays of one IVF-PQ shard over rows [lo, hi): filed by
    argmax x·c − ½‖c‖² in the rotated space, residual PQ codes by nearest
    codeword, rows grouped by list in id order."""
    xr = data["x"][lo:hi] @ data["rotation"]
    c = data["coarse"]
    assign = np.argmax(xr @ c.T - 0.5 * (c * c).sum(1), axis=1)
    resid = (xr - c[assign]).reshape(hi - lo, M, D // M)
    cb = data["codebooks"]
    codes = np.stack([np.argmin(((resid[:, m, None, :] - cb[m][None]) ** 2).sum(-1), axis=1) for m in range(M)], 1)
    order = np.argsort(assign, kind="stable")
    offsets = np.zeros(NLIST + 1, np.int64)
    np.cumsum(np.bincount(assign, minlength=NLIST), out=offsets[1:])
    return dict(d=D, coarse_centroids=c, codebooks=cb, rotation=data["rotation"], list_offsets=offsets,
                list_ids=(order + id_offset).astype(np.int64), list_codes=codes[order].astype(np.uint8), nprobe=4,
                refine_vectors=data["x"][lo:hi].astype(np.float16) if refine else None, rerank_factor=4)


def _shards(kind, data, offsets=None, refine=(True, True, True)):
    """(JAX shards, port shards) over the SPLIT row ranges, shard s with ids
    from offsets[s] (its first row by default)."""
    offsets = SPLIT[:-1] if offsets is None else offsets
    jax_shards, torch_shards = [], []
    for (lo, hi), off, ref in zip(zip(SPLIT[:-1], SPLIT[1:]), offsets, refine):
        if kind == "ivfpq":
            arrays = _pq_shard_arrays(data, lo, hi, off, ref)
            jax_shards.append(JPQ(**arrays))
            torch_shards.append(TPQ(**arrays, device="cpu"))
        else:
            kw = dict(nlist=NLIST, nprobe=4, coarse=data["coarse"], id_offset=off, refine=ref,
                      refine_source=data["x"][lo:hi].astype(np.float16) if ref else None)
            jax_shards.append(JIVF.from_vectors(data["x"][lo:hi], **kw))
            torch_shards.append(TIVF.from_vectors(data["x"][lo:hi], **kw, device="cpu"))
    return jax_shards, torch_shards


ARRAYS = {"ivfpq": ("list_offsets", "list_ids", "list_codes", "coarse_centroids", "codebooks", "rotation"),
          "ivf_int8": ("list_offsets", "list_ids", "q_vectors", "scales", "coarse_centroids")}


def _assert_same_arrays(kind, got, want):
    for name in ARRAYS[kind]:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), name)
    if want.refine_vectors is None:
        assert got.refine_vectors is None
    else:
        np.testing.assert_array_equal(np.asarray(got.refine_vectors), np.asarray(want.refine_vectors))


def _jax_search_ready(ix):
    if isinstance(ix, JIVF):
        ix.union, ix.exact_topk = "exact", True
    return ix


@pytest.mark.parametrize("kind", ["ivfpq", "ivf_int8"])
def test_combined_arrays_equal_and_ids_identical(kind, data):
    jax_shards, torch_shards = _shards(kind, data)
    combine_j = j_comb.combine_ivfpq if kind == "ivfpq" else j_comb.combine_ivf_int8
    combine_t = t_comb.combine_ivfpq if kind == "ivfpq" else t_comb.combine_ivf_int8
    jm, tm = combine_j(jax_shards), combine_t(torch_shards)
    assert tm.ntotal == N and tm.device.type == "cpu"
    _assert_same_arrays(kind, tm, jm)
    # refine rows land at their global ids
    np.testing.assert_array_equal(np.asarray(tm.refine_vectors[1500]), data["x"][1500].astype(np.float16))
    for refine in (True, False):
        if not refine:
            jm.refine_vectors = tm.refine_vectors = None
        tv, ti = tm.search(data["q"], K)
        jv, ji = _jax_search_ready(jm).search(data["q"], K)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)


def test_combined_ivf_int8_equals_the_whole_build(data):
    """Shard builds against one coarse quantizer, combined, give the arrays
    of the whole-corpus build: ids within a list stay in id order."""
    _, torch_shards = _shards("ivf_int8", data, refine=(False, False, False))
    merged = t_comb.combine_ivf_int8(torch_shards)
    whole = TIVF.from_vectors(data["x"], nlist=NLIST, nprobe=4, coarse=data["coarse"], device="cpu")
    _assert_same_arrays("ivf_int8", merged, whole)
    np.testing.assert_array_equal(merged.search(data["q"], K)[1], whole.search(data["q"], K)[1])


@pytest.mark.parametrize("kind", ["ivfpq", "ivf_int8"])
def test_index_combiner_folders_byte_equal_and_cross_load(kind, data, tmp_path):
    jax_shards, torch_shards = _shards(kind, data)
    for s, (jx, tx) in enumerate(zip(jax_shards, torch_shards)):
        jx.save(str(tmp_path / "jax_shards" / f"shard{s}"))
        tx.save(str(tmp_path / "torch_shards" / f"shard{s}"))
    jm = j_comb.index_combiner(str(tmp_path / "jax_shards"), str(tmp_path / "jax_merged"))
    tm = t_comb.index_combiner(str(tmp_path / "torch_shards"), str(tmp_path / "torch_merged"), device="cpu")
    assert tm.device.type == "cpu" and tm.ntotal == jm.ntotal == N
    jdir, tdir = tmp_path / "jax_merged" / "populated.index", tmp_path / "torch_merged" / "populated.index"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        if name == "header.json":
            assert json.loads((jdir / name).read_text()) == json.loads((tdir / name).read_text())
        else:
            assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    # each package loads the other's folder and searches it to the same ids
    j_of_t, t_of_j = _jax_search_ready(j_load(str(tdir))), t_load(str(jdir), device="cpu")
    want = _jax_search_ready(jm).search(data["q"], K)[1]
    np.testing.assert_array_equal(j_of_t.search(data["q"], K)[1], want)
    np.testing.assert_array_equal(t_of_j.search(data["q"], K)[1], want)
    np.testing.assert_array_equal(
        t_order.search_to_new_ids(t_of_j, data["q"], K), j_order.search_to_new_ids(_jax_search_ready(jm), data["q"], K)
    )


@pytest.mark.parametrize("kind", ["ivfpq", "ivf_int8"])
def test_refine_drop_warnings_fire_in_both(kind, data, capsys):
    # only some shards carry a refine store
    jax_shards, torch_shards = _shards(kind, data, refine=(True, False, True))
    combine_j = j_comb.combine_ivfpq if kind == "ivfpq" else j_comb.combine_ivf_int8
    combine_t = t_comb.combine_ivfpq if kind == "ivfpq" else t_comb.combine_ivf_int8
    jm = combine_j(jax_shards)
    jax_out = capsys.readouterr().out
    tm = combine_t(torch_shards)
    torch_out = capsys.readouterr().out
    assert "only 2/3 shards carry an exact re-rank store" in torch_out and torch_out == jax_out
    assert tm.refine_vectors is None and jm.refine_vectors is None
    # ids that do not tile 0..N-1 (a gap after the first shard)
    jax_shards, torch_shards = _shards(kind, data, offsets=(0, 1500, 2300))
    jm = combine_j(jax_shards)
    jax_out = capsys.readouterr().out
    tm = combine_t(torch_shards)
    torch_out = capsys.readouterr().out
    assert "shard ids do not tile the merged range" in torch_out and torch_out == jax_out
    assert tm.refine_vectors is None and jm.refine_vectors is None
    _assert_same_arrays(kind, tm, jm)
    for order in (t_order, j_order):
        with pytest.raises(ValueError, match="permutation"):
            order.get_old_to_new_mapping(tm)

"""The port's metadata preparation against the JAX package's, on the CPU:
`index/metadata_order.py` (old→new mapping, per-shard re-keying, external
sort into a sink), `back/prepro.py::parquet_to_arrow` and the metadata
providers of `back/metadata.py`.

The same parquet shards and index arrays go to both packages; the sorted
rows, the mapping, the reordered hdf5 and the arrow files must be equal
between them, and files written by either package load in both packages'
providers with the same rows as the parquet provider's.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from clip_retrieval_tpu.back import metadata as j_meta
from clip_retrieval_tpu.back import prepro as j_prepro
from clip_retrieval_tpu.index import metadata_order as j_order
from clip_retrieval_tpu.index.ivfpq import IVFPQIndex as JPQ
from clip_retrieval_tpu_torch.back import metadata as t_meta
from clip_retrieval_tpu_torch.back import prepro as t_prepro
from clip_retrieval_tpu_torch.index import metadata_order as t_order
from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex as TPQ

PACKAGES = {"jax": (j_meta, j_prepro, j_order), "torch": (t_meta, t_prepro, t_order)}


@pytest.fixture()
def meta_folder(tmp_path):
    folder = tmp_path / "metadata"
    folder.mkdir()
    for shard in range(2):
        n = 5
        pd.DataFrame({
            "caption": [f"cap {shard}-{i}" for i in range(n)],
            "url": [f"http://x/{shard}/{i}" for i in range(n)],
            "score": np.arange(n, dtype=np.float32) + 10 * shard,
        }).to_parquet(folder / f"metadata_{shard}.parquet")
    return str(folder)


def _tiny_ivf(cls, **kw):
    """IVF-PQ index with a known list layout: ids reversed across 2 lists."""
    rng = np.random.default_rng(0)
    d, nlist, m = 8, 2, 4
    return cls(d=d, coarse_centroids=rng.normal(size=(nlist, d)).astype(np.float32),
               codebooks=rng.normal(size=(m, 256, d // m)).astype(np.float32), rotation=None,
               list_offsets=np.array([0, 5, 10], np.int64), list_ids=np.array([9, 7, 5, 3, 1, 8, 6, 4, 2, 0], np.int64),
               list_codes=rng.integers(0, 256, (10, m)).astype(np.uint8), **kw)


def _caption(row):
    c = row["caption"]
    return c.decode() if isinstance(c, bytes) else c


def test_old_to_new_mapping_matches_jax():
    mapping = t_order.get_old_to_new_mapping(_tiny_ivf(TPQ, device="cpu"))
    assert mapping[9] == 0 and mapping[0] == 9  # old id 9 sits at position 0 of the IVF-ordered storage
    np.testing.assert_array_equal(mapping, j_order.get_old_to_new_mapping(_tiny_ivf(JPQ)))
    bad = _tiny_ivf(TPQ, device="cpu")
    bad.list_ids = bad.list_ids + 10  # offset ids: not a permutation of 0..N-1
    with pytest.raises(ValueError, match="permutation"):
        t_order.get_old_to_new_mapping(bad)


@pytest.mark.parametrize("buffer_size", [3, 10 ** 6])
def test_reorder_and_external_sort_match_jax(meta_folder, tmp_path, buffer_size):
    rows = {}
    for name, (_, _, order) in PACKAGES.items():
        ix = _tiny_ivf(TPQ, device="cpu") if name == "torch" else _tiny_ivf(JPQ)
        out = tmp_path / f"reordered_{name}"
        order.re_order_parquet(ix, meta_folder, str(out), ["caption", "url"])
        sink = order.DummySink()
        order.external_sort_parquet(sink, str(out), buffer_size=buffer_size)
        rows[name] = sink.rows
    assert rows["torch"] == rows["jax"]
    assert [r["new_id"] for r in rows["torch"]] == list(range(10))
    assert rows["torch"][0]["caption"] == "cap 1-4"  # new_id 0 holds old id 9


def test_reordered_hdf5_and_mapping_bytes_equal(meta_folder, tmp_path):
    """`load_metadata_provider` with reorder_metadata_by_ivf_index writes the
    same `ivf_old_to_new_mapping.npy` and `metadata_reordered.hdf5` in both
    packages, and each package's provider reads the other's files."""
    import shutil

    folders = {}
    for name, (meta, _, _) in PACKAGES.items():
        folder = tmp_path / name
        shutil.copytree(meta_folder, folder / "metadata")
        ix = _tiny_ivf(TPQ, device="cpu") if name == "torch" else _tiny_ivf(JPQ)
        prov, mapping = meta.load_metadata_provider(str(folder), True, True, ix, ["caption", "url"], False)
        assert mapping is not None and mapping.dtype == np.int64
        np.testing.assert_array_equal(np.asarray(mapping), j_order.get_old_to_new_mapping(ix))
        folders[name] = folder
    for artifact in ("ivf_old_to_new_mapping.npy", "metadata_reordered.hdf5"):
        assert (folders["torch"] / artifact).read_bytes() == (folders["jax"] / artifact).read_bytes(), artifact
    mapping = j_order.get_old_to_new_mapping(_tiny_ivf(JPQ))
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        prov = PACKAGES[reader][0].Hdf5MetadataProvider(str(folders[writer] / "metadata_reordered.hdf5"))
        got = prov.get(mapping[[0, 9, 3]].tolist(), ["caption", "url"])
        assert [_caption(r) for r in got] == ["cap 0-0", "cap 1-4", "cap 0-3"]


def test_reorder_needs_the_hdf5_provider(meta_folder, tmp_path, capsys):
    import shutil

    shutil.copytree(meta_folder, tmp_path / "f" / "metadata")
    prov, mapping = t_meta.load_metadata_provider(str(tmp_path / "f"), False, True, None, ["caption"], False)
    assert mapping is None and isinstance(prov, t_meta.ParquetMetadataProvider)
    assert "requires the hdf5 provider" in capsys.readouterr().out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_arrow_files_load_in_both_packages(meta_folder, tmp_path, writer):
    arrow_dir = str(tmp_path / "arrow")
    PACKAGES[writer][1].parquet_to_arrow(meta_folder, arrow_dir, max_rows_per_file=5)
    other = str(tmp_path / "arrow_other")
    PACKAGES["jax" if writer == "torch" else "torch"][1].parquet_to_arrow(meta_folder, other, max_rows_per_file=5)
    names = sorted(p.name for p in (tmp_path / "arrow").glob("*.arrow"))
    assert names == ["0.arrow", "1.arrow"]  # rotated at 5 rows
    for n in names:
        assert (tmp_path / "arrow" / n).read_bytes() == (tmp_path / "arrow_other" / n).read_bytes()
    want = t_meta.ParquetMetadataProvider(meta_folder).get([7, 2, 7, 0, 10 ** 9, -1], ["caption", "score"])
    for meta in (j_meta, t_meta):
        assert meta.ArrowMetadataProvider(arrow_dir).get([7, 2, 7, 0, 10 ** 9, -1], ["caption", "score"]) == want


def test_parquet_to_arrow_failure_leaves_no_truncated_file(tmp_path):
    folder = tmp_path / "meta"
    folder.mkdir()
    pd.DataFrame({"a": [1, 2]}).to_parquet(folder / "m0.parquet")
    pd.DataFrame({"b": ["x"]}).to_parquet(folder / "m1.parquet")  # schema drift: write_table raises
    out = tmp_path / "arrow"
    with pytest.raises(Exception):
        t_prepro.parquet_to_arrow(str(folder), str(out))
    assert list(out.glob("*.arrow")) == []
    with pytest.raises(ValueError, match="no parquet files"):
        t_prepro.parquet_to_arrow(str(tmp_path / "arrow"), str(tmp_path / "x"))


def test_parquet_to_arrow_rotation_failure_keeps_complete_files(tmp_path, monkeypatch):
    folder = tmp_path / "meta"
    folder.mkdir()
    pd.DataFrame({"a": [1, 2]}).to_parquet(folder / "m0.parquet")
    pd.DataFrame({"a": [3, 4]}).to_parquet(folder / "m1.parquet")
    out = tmp_path / "arrow"
    real_new_file, calls = pa.ipc.new_file, []

    def failing_new_file(sink, schema, **kw):
        calls.append(1)
        if len(calls) == 2:  # the rotation open
            raise OSError("disk full")
        return real_new_file(sink, schema, **kw)

    monkeypatch.setattr(pa.ipc, "new_file", failing_new_file)
    with pytest.raises(OSError):
        t_prepro.parquet_to_arrow(str(folder), str(out), max_rows_per_file=2)
    assert sorted(p.name for p in out.glob("*.arrow")) == ["0.arrow"]
    with pa.memory_map(str(out / "0.arrow")) as src:
        assert pa.ipc.open_file(src).read_all().num_rows == 2


def test_parquet_to_arrow_retries_a_failed_read_once(meta_folder, tmp_path, monkeypatch):
    import pyarrow.parquet as pq

    real_read, calls = pq.read_table, []

    def flaky_read(path, **kw):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("transient")
        return real_read(path, **kw)

    monkeypatch.setattr(pq, "read_table", flaky_read)
    monkeypatch.setattr(t_prepro.time, "sleep", lambda s: None)
    t_prepro.parquet_to_arrow(meta_folder, str(tmp_path / "arrow"))
    assert len(calls) == 3  # the first shard twice, the second once
    assert t_meta.ArrowMetadataProvider(str(tmp_path / "arrow")).table.num_rows == 10


@pytest.mark.parametrize("ids", [[3, 10 ** 9, -1, 0], [7, 2, 7, 0]], ids=["invalid", "duplicate-unsorted"])
def test_providers_match_jax(meta_folder, tmp_path, ids):
    """Every provider of the port gives the JAX provider's rows, {} at the
    position of an out-of-range id, in the order asked."""
    got = {}
    for name, (meta, prepro, _) in PACKAGES.items():
        h5 = str(tmp_path / f"{name}.hdf5")
        meta.parquet_to_hdf5(meta_folder, h5, ["caption", "url"])
        prepro.parquet_to_arrow(meta_folder, str(tmp_path / f"arrow_{name}"), ["caption", "url"])
        got[name] = [prov.get(ids, ["caption", "url"]) for prov in (
            meta.ParquetMetadataProvider(meta_folder), meta.Hdf5MetadataProvider(h5),
            meta.ArrowMetadataProvider(str(tmp_path / f"arrow_{name}")))]
    assert got["torch"] == got["jax"]
    assert (tmp_path / "torch.hdf5").read_bytes() == (tmp_path / "jax.hdf5").read_bytes()
    for rows in got["torch"]:
        assert len(rows) == len(ids)
        assert [_caption(r) if r else None for r in rows] == [
            None if not 0 <= i < 10 else f"cap {i // 5}-{i % 5}" for i in ids]

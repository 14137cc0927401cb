"""IVF-order metadata re-ordering + external merge sort.

Counterpart of `clip_retrieval_tpu/index/metadata_order.py` (pure host
code, copied).  Serving fetches metadata for kNN results; results come out
clustered by IVF list, so storing metadata in IVF-list order turns scattered
point reads into near-sequential ones.  The inverted lists are plain arrays,
so the old→new mapping is one pass over `list_ids`.  The external sort
re-keys each metadata parquet shard by new_id and sorts it, then streams a
k-way heap merge into an HDF5 sink with bounded memory (a buffer flushed
every 10^6 rows).  `search_to_new_ids` searches through the index's own
device route (kernel K3 or K4 on a card).
"""

from __future__ import annotations

import heapq
from pathlib import Path
from typing import List

import numpy as np


def get_old_to_new_mapping(index) -> np.ndarray:
    """(ntotal,) array: old_to_new[old_id] = row in IVF-ordered storage.

    Requires ids to be exactly 0..ntotal-1 (what clip_index builds emit).
    Combined indices whose ids don't tile that range (combiner warns about
    these) cannot be IVF-reordered — raise instead of returning a mapping
    with uninitialized garbage entries."""
    list_ids = np.asarray(index.list_ids)
    n = list_ids.shape[0]
    if list_ids.size and (
        list_ids.min() < 0
        or list_ids.max() >= n
        or np.unique(list_ids).size != n
    ):
        raise ValueError(
            "IVF metadata reordering requires ids to be a permutation of "
            f"0..{n - 1}; this index's ids are not (e.g. a combined index "
            "with offset ids) — serve it without "
            "reorder_metadata_by_ivf_index"
        )
    mapping = np.full((n,), -1, np.int64)
    mapping[list_ids] = np.arange(n, dtype=np.int64)
    return mapping


def search_to_new_ids(index, query: np.ndarray, k: int) -> np.ndarray:
    """Search and remap result ids to IVF order (reference `:17-43`)."""
    mapping = get_old_to_new_mapping(index)
    _, ids = index.search(query, k)
    return np.where(ids >= 0, mapping[np.maximum(ids, 0)], -1)


def re_order_parquet(
    index, parquet_folder: str, output_folder: str, columns_to_return: List[str]
):
    """Add new_id (IVF position) to each metadata shard, sort within shard."""
    import pandas as pd

    mapping = get_old_to_new_mapping(index)
    files = sorted(Path(parquet_folder).glob("*.parquet"))
    offset = 0
    Path(output_folder).mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(files):
        df = pd.read_parquet(f)
        keep = [c for c in df.columns if c in set(columns_to_return)]
        df = df[keep]
        df["new_id"] = mapping[offset : offset + len(df)]
        offset += len(df)
        df = df.sort_values("new_id")
        df.to_parquet(Path(output_folder) / f"reordered_{i:05d}.parquet")


class DummySink:
    """Collects rows in memory (tests)."""

    def __init__(self):
        self.rows: list[dict] = []

    def write(self, batch_df):
        self.rows.extend(batch_df.to_dict("records"))

    def close(self):
        pass


class Hdf5Sink:
    """Appends sorted batches into contiguous hdf5 columns."""

    def __init__(self, output_hdf5_file: str, columns_to_return: List[str]):
        import h5py

        self.f = h5py.File(output_hdf5_file, "w")
        self.ds = self.f.create_group("dataset")
        self.columns = columns_to_return
        self._h5py = h5py

    def write(self, batch_df):
        for k in batch_df.columns:
            if k == "new_id" or k not in self.columns:
                continue
            col = batch_df[k]
            if str(col.dtype) in ("float64", "float32"):
                col = col.fillna(0.0)
            elif str(col.dtype) in ("int64", "int32"):
                col = col.fillna(0)
            elif col.dtype == object:
                col = col.fillna("").str.replace("\x00", "", regex=False)
            z = col.to_numpy()
            if z.dtype == object:
                z = z.astype(self._h5py.string_dtype())
            if k not in self.ds:
                self.ds.create_dataset(
                    k, data=z, maxshape=(None,), compression="gzip"
                )
            else:
                prev = len(self.ds[k])
                self.ds[k].resize((prev + len(z),))
                self.ds[k][prev:] = z

    def close(self):
        self.f.close()


def external_sort_parquet(
    sink, input_folder: str, buffer_size: int = 10 ** 6
):
    """k-way heap merge of per-shard new_id-sorted parquet into the sink.

    Bounded memory: each input file is streamed one row-group batch at a
    time (pyarrow iter_batches) — never materialized whole — so resident
    usage is O(files · row_group) + the output buffer, which is what makes
    the billion-row reorder (reference ivf_metadata_ordering.py:145-190)
    feasible.  Rows are plain dicts via to_dict('records'), preserving
    column names that itertuples would mangle (keywords, spaces, dupes)."""
    import pandas as pd
    import pyarrow.parquet as pq

    files = sorted(Path(input_folder).glob("*.parquet"))

    def row_iter(path):
        pf = pq.ParquetFile(path)
        for batch in pf.iter_batches():
            for row in batch.to_pandas().to_dict("records"):
                yield row

    merged = heapq.merge(
        *[row_iter(f) for f in files], key=lambda r: r["new_id"]
    )
    buffer: list[dict] = []
    for row in merged:
        buffer.append(row)
        if len(buffer) >= buffer_size:
            sink.write(pd.DataFrame(buffer))
            buffer = []
    if buffer:
        sink.write(pd.DataFrame(buffer))
    sink.close()

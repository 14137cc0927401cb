"""Metadata providers: parquet (RAM), hdf5 (contiguous-id cache), arrow (mmap).

Copy of `clip_retrieval_tpu/back/metadata.py`: three interchangeable
`get(ids, cols)` backends and the same lazy conversion cascade as the
upstream clip-retrieval `clip_back.py`: arrow = the scale path (zero-copy
mmap), hdf5 = a one-time parquet→hdf5 cache (in id order, or in IVF-list
order with `reorder_metadata_by_ivf_index`: `metadata_reordered.hdf5` and
the int64 `ivf_old_to_new_mapping.npy` memmap, on-disk contracts shared with
the JAX package), parquet = in-RAM pandas for small corpora.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, List, Sequence

import numpy as np


class ParquetMetadataProvider:
    """In-RAM pandas over the metadata parquet shards."""

    def __init__(self, parquet_folder: str):
        import pandas as pd

        self.metadata_df = pd.concat(
            pd.read_parquet(p)
            for p in sorted(Path(parquet_folder).glob("*.parquet"))
        ).reset_index(drop=True)
        self._np_cols: dict[str, np.ndarray] = {}

    def get(self, ids: Sequence[int], cols: List[str] | None = None):
        available = self.metadata_df.columns.tolist()
        cols = available if cols is None else [
            c for c in available if c in set(cols)
        ]
        # column-wise numpy takes beat df.iloc row materialization ~20×
        # (benchmarks/bench_metadata_fetch.py); cached lazily per REQUESTED
        # column — wide LAION-style sets should not pay conversion latency
        # or a second full-width RAM copy for columns never returned
        for c in cols:
            if c not in self._np_cols:
                self._np_cols[c] = self.metadata_df[c].to_numpy()
        idx = np.asarray(list(ids), np.int64)
        n = len(self.metadata_df)
        valid = (idx >= 0) & (idx < n)
        if not cols:
            return [{} for _ in idx]
        safe = np.where(valid, idx, 0)
        taken = [self._np_cols[c][safe] for c in cols]
        return [
            dict(zip(cols, vals)) if ok else {}
            for ok, vals in zip(valid, zip(*taken))
        ]


def parquet_to_hdf5(
    parquet_folder: str, output_hdf5_file: str, columns_to_return: List[str]
):
    """One-time conversion: parquet shards → one hdf5 with contiguous
    columns (NaN/NUL scrubbed like the reference, clip_back.py:539-566)."""
    import h5py
    import pandas as pd
    import pyarrow.parquet as pq

    files = sorted(Path(parquet_folder).glob("*.parquet"))
    # fix the column set up front from the UNION of shard schemas: appending
    # per-shard columns independently would misalign any column missing
    # from an early shard (its rows would map onto the wrong ids)
    import pyarrow as pa

    all_cols: dict[str, str] = {}  # name -> "str" | "num"
    for f_ in files:
        schema = pq.ParquetFile(f_).schema_arrow
        for field in schema:
            if field.name in columns_to_return and field.name not in all_cols:
                all_cols[field.name] = (
                    "str"
                    if pa.types.is_string(field.type)
                    or pa.types.is_large_string(field.type)
                    or pa.types.is_binary(field.type)
                    else "num"
                )
    with h5py.File(output_hdf5_file, "w") as f:
        ds = f.create_group("dataset")
        for parquet_file in files:
            df = pd.read_parquet(parquet_file)
            for k, kind in all_cols.items():
                if k not in df.columns:
                    # shard lacks the column: type-consistent fill keeps
                    # every column aligned to the same global row range
                    df[k] = "" if kind == "str" else 0.0
                col = df[k]
                if str(col.dtype) in ("float64", "float32"):
                    col = col.fillna(0.0)
                elif str(col.dtype) in ("int64", "int32"):
                    col = col.fillna(0)
                elif col.dtype == object:
                    col = col.fillna("").str.replace("\x00", "", regex=False)
                z = col.to_numpy()
                if z.dtype == object:
                    z = z.astype(h5py.string_dtype())
                if k not in ds:
                    ds.create_dataset(
                        k, data=z, maxshape=(None,), compression="gzip"
                    )
                else:
                    prev = len(ds[k])
                    ds[k].resize((prev + len(z),))
                    ds[k][prev:] = z


class Hdf5MetadataProvider:
    def __init__(self, hdf5_file: str):
        import h5py

        self.f = h5py.File(hdf5_file, "r")
        self.ds = self.f["dataset"]

    def get(self, ids: Sequence[int], cols: List[str] | None = None):
        items: list[dict[str, Any]] = [{} for _ in ids]
        keys = list(self.ds.keys())
        cols = keys if cols is None else [c for c in keys if c in set(cols)]
        idx = np.asarray(list(ids), np.int64)
        if idx.size == 0:
            return items
        nrows = self.ds[cols[0]].shape[0] if cols else 0
        bad = (idx < 0) | (idx >= nrows)
        if bad.any():  # out-of-range ids stay {} at their position
            idx = np.where(bad, 0, idx)
        # h5py fancy selection needs increasing unique indices; one sorted
        # bulk read per column replaces a per-id dataset read (~100× under
        # the IVF-reordered serving pattern, where ids are near-consecutive)
        uniq, inverse = np.unique(idx, return_inverse=True)
        lo, hi = int(uniq[0]), int(uniq[-1])
        dense = (hi - lo + 1) <= 4 * uniq.size + 1024
        for k in cols:
            dset = self.ds[k]
            if dense:  # contiguous slice read, then take
                block = dset[lo : hi + 1]
                vals = block[uniq - lo][inverse]
            else:
                vals = dset[uniq][inverse]
            for i in range(idx.size):
                if not bad[i]:
                    items[i][k] = vals[i]
        return items


class ArrowMetadataProvider:
    """Zero-copy mmap over arrow IPC files (the billion-scale path)."""

    def __init__(self, arrow_folder: str):
        import pyarrow as pa

        arrow_files = [
            str(a)
            for a in sorted(Path(arrow_folder).glob("**/*"))
            if a.is_file() and not a.name.endswith(".parquet")
        ]
        self.table = pa.concat_tables(
            [
                pa.ipc.RecordBatchFileReader(
                    pa.memory_map(arrow_file, "r")
                ).read_all()
                for arrow_file in arrow_files
            ]
        )
        # chunk-aware take scaffolding: Table.take on a multi-chunk mmap'd
        # table is pathologically slow (measured 1.6 s vs 0.7 ms for 40
        # rows), and combine_chunks() would materialize the whole table in
        # RAM — defeating the zero-copy mmap this provider exists for.
        # Record batches are zero-copy views; takes run per-batch below.
        self._batches = self.table.to_batches()
        self._starts = np.cumsum(
            [0] + [b.num_rows for b in self._batches]
        )

    def get(self, ids: Sequence[int], cols: List[str] | None = None):
        names = self.table.schema.names
        cols = names if cols is None else [c for c in names if c in set(cols)]
        idx = np.asarray(list(ids), np.int64)
        # out-of-range ids yield {} at their position — callers zip results
        # with the requested ids, so the list must stay aligned (and a bad
        # id in a /metadata POST must not 500 the whole batch)
        out: list[dict[str, Any]] = [{} for _ in range(idx.size)]
        if idx.size == 0:
            return out
        valid = (idx >= 0) & (idx < self._starts[-1])
        batch_of = np.searchsorted(self._starts, idx, side="right") - 1
        for b in np.unique(batch_of[valid]):
            pos = np.nonzero(valid & (batch_of == b))[0]
            local = idx[pos] - self._starts[b]
            rows = (
                self._batches[b].select(cols).take(local).to_pylist()
            )
            for p, row in zip(pos, rows):
                out[p] = row
        return out


def load_metadata_provider(
    indice_folder: str,
    enable_hdf5: bool,
    reorder_metadata_by_ivf_index: bool,
    image_index,
    columns_to_return: List[str],
    use_arrow: bool,
):
    """Provider selection + lazy conversion cascade; returns (provider,
    ivf_old_to_new_mapping), the mapping None unless the metadata is served
    in IVF order (reference clip_back.py:618-653)."""
    parquet_folder = indice_folder + "/metadata"
    ivf_old_to_new_mapping = None
    if reorder_metadata_by_ivf_index and (use_arrow or not enable_hdf5):
        print(
            "WARNING: reorder_metadata_by_ivf_index requires the hdf5 "
            "provider (enable_hdf5=True, use_arrow=False) — serving "
            "without IVF metadata reordering"
        )
    if use_arrow:
        return ArrowMetadataProvider(parquet_folder), None
    if enable_hdf5:
        if reorder_metadata_by_ivf_index:
            from ..index.metadata_order import Hdf5Sink, external_sort_parquet, get_old_to_new_mapping, re_order_parquet

            hdf5_path = indice_folder + "/metadata_reordered.hdf5"
            mapping_path = indice_folder + "/ivf_old_to_new_mapping.npy"
            if not os.path.exists(mapping_path):
                mapping = get_old_to_new_mapping(image_index)
                mm = np.memmap(mapping_path, dtype="int64", mode="w+", shape=mapping.shape)
                mm[:] = mapping
                mm.flush()
                del mm
            ivf_old_to_new_mapping = np.memmap(mapping_path, dtype="int64", mode="r")
            if not os.path.exists(hdf5_path):
                with tempfile.TemporaryDirectory() as tmpdir:
                    re_order_parquet(image_index, parquet_folder, tmpdir, columns_to_return)
                    external_sort_parquet(Hdf5Sink(hdf5_path, columns_to_return), tmpdir)
        else:
            hdf5_path = indice_folder + "/metadata.hdf5"
            if not os.path.exists(hdf5_path):
                parquet_to_hdf5(parquet_folder, hdf5_path, columns_to_return)
        return Hdf5MetadataProvider(hdf5_path), ivf_old_to_new_mapping
    return ParquetMetadataProvider(parquet_folder), None

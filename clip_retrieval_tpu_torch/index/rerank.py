"""Exact re-ranking over stored fp16 rows (faiss IndexRefineFlat analogue).

Copy of `clip_retrieval_tpu/index/rerank.py` (host numpy, no device work).
Shared by the IVF tiers: the approximate scan selects rerank_factor·k
candidates, the true vectors re-score them — lifting recall to near-exact
while reading only rerank_factor·k (mmap'd) rows per query.
"""

from __future__ import annotations

import numpy as np


class ShardRowGather:
    """Read-only (n, d) fp16 row view over a folder of embedding shards.

    Serves as a refine store backed directly by the ORIGINAL fp16 shards
    (which already hold the vectors in id order): building an index with
    refine on no longer writes a second corpus-sized fp16 scratch copy
    (~100 GB at the 100M×512 tier).  Supports the fancy row gather
    `exact_rerank` performs and contiguous slices for streaming save.
    The view references the source shard files — `save()` persists a real
    copy into the index dir, so saved indices stay self-contained.
    """

    def __init__(self, shards):
        # `shards` is build.EmbeddingShards (duck-typed to avoid an
        # import cycle): .arrays mmap'd, .counts, .d, .total
        self._arrays = shards.arrays
        self._offs = np.cumsum([0, *shards.counts])
        self.shape = (int(shards.total), int(shards.d))
        self.dtype = np.dtype(np.float16)
        self.ndim = 2

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx) -> np.ndarray:
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self.shape[0])
            if step != 1:
                raise IndexError("ShardRowGather supports step-1 slices")
            idx = np.arange(start, stop)
        idx = np.asarray(idx)
        if idx.ndim == 0:  # scalar index → (d,) row, ndarray semantics
            return self[idx[None]][0]
        out = np.empty((idx.shape[0], self.shape[1]), np.float16)
        shard_of = np.searchsorted(self._offs, idx, side="right") - 1
        for si in np.unique(shard_of):
            m = shard_of == si
            out[m] = np.asarray(
                self._arrays[si][idx[m] - self._offs[si]], np.float16
            )
        return out


def save_rows_fp16(path: str, rows, chunk: int = 1 << 17) -> None:
    """Write a row source (ndarray, memmap, or ShardRowGather) as an fp16
    .npy without materializing it in RAM."""
    from numpy.lib.format import open_memmap

    out = open_memmap(
        path, mode="w+", dtype=np.float16, shape=tuple(rows.shape)
    )
    for i in range(0, rows.shape[0], chunk):
        out[i : i + chunk] = np.asarray(rows[i : i + chunk], np.float16)
    out.flush()
    del out


def exact_rerank(
    refine_vectors,  # (ntotal, d) fp16, indexed by original id (may be mmap)
    queries: np.ndarray,
    ids: np.ndarray,  # (B, k') candidate ids, −1 = empty slot
    k: int,
):
    """Re-score candidate ids against the exact stored rows; returns the
    top-k (vals, ids) per query in exact-score order."""
    q = np.asarray(queries, np.float32)
    out_vals = np.full((q.shape[0], k), -np.inf, np.float32)
    out_ids = np.full((q.shape[0], k), -1, np.int64)
    for b in range(q.shape[0]):
        cand = ids[b][ids[b] >= 0]
        if cand.size == 0:
            continue
        vecs = np.asarray(refine_vectors[cand], np.float32)
        sc = vecs @ q[b]
        kk = min(k, sc.size)
        top = np.argpartition(-sc, kk - 1)[:kk]
        order = top[np.argsort(-sc[top])]
        out_vals[b, :kk] = sc[order]
        out_ids[b, :kk] = cand[order]
    return out_vals, out_ids

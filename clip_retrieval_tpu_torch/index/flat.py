"""Flat exact inner-product index: one matmul + top-k on the device.

Counterpart of `clip_retrieval_tpu/index/flat.py`, with the same on-disk
format (`header.json`, `vectors.npy`, optional `ids.npy`): an index either
package saves loads in the other.  Vectors live host-side in fp16; search
streams them to `device` in blocks of at most `STREAM_BYTES` with a running
top-k merge, so corpora larger than device memory still search.  The
serving-time dedup uses `range_search`, which stays on the host as in the
JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from ..ops.topk import topk_ip, topk_merge
from ..utils.device import resolve_device

_DEVICE_CHUNK = 1 << 20  # DB rows per range_search block
STREAM_BYTES = 32 << 20  # host→device block size of a search


def _stream_rows(d: int) -> int:
    """DB rows per host→device block of a search."""
    return max(1024, STREAM_BYTES // (d * 2))


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array (possibly a read-only memmap slice) as a tensor on device."""
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)


class FlatIndex:
    """Exact IP index; ids are positions unless explicit ids are added."""

    index_type = "flat"

    def __init__(self, d: int, vectors: np.ndarray | None = None, ids: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        self.d = d
        self.device = resolve_device(device)
        self._chunks: list[np.ndarray] = []
        self.vectors = np.zeros((0, d), np.float16) if vectors is None else np.asarray(vectors, np.float16)
        self.ids = None if ids is None else np.asarray(ids, np.int64)

    # -- construction ------------------------------------------------------

    @property
    def ntotal(self) -> int:
        return self.vectors.shape[0] + sum(c.shape[0] for c in self._chunks)

    def add(self, x: np.ndarray):
        if self.ids is not None:
            # positions past len(self.ids) would resolve out of bounds (or
            # silently mislabel); faiss likewise rejects plain add() on an
            # ID-mapped index
            raise ValueError(
                "add() on an explicit-ids FlatIndex is unsupported; construct with vectors= and ids= instead"
            )
        self._chunks.append(np.asarray(x, np.float16))

    def _materialize(self):
        if self._chunks:
            self.vectors = np.concatenate([self.vectors, *self._chunks])
            self._chunks = []

    # -- search ------------------------------------------------------------

    def _resolve(self, ids: np.ndarray) -> np.ndarray:
        return ids if self.ids is None else self.ids[ids]

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(B, d) → (scores (B,k) f32, ids (B,k) i64); ids −1 beyond ntotal."""
        self._materialize()
        n = self.vectors.shape[0]
        q = to_device(np.asarray(queries, np.float32), self.device)
        k_eff = min(k, max(n, 1))
        if n == 0:
            b = q.shape[0]
            return np.full((b, k), -np.inf, np.float32), np.full((b, k), -1, np.int64)
        # each block keeps its top-min(k_eff, rows) candidates, so blocks
        # must hold ≥ k_eff rows or a block containing more than
        # `stream_rows` of the true top-k would silently lose the excess
        stream_rows = max(_stream_rows(self.d), k_eff)
        vals = idx = None
        for start in range(0, n, stream_rows):
            block = to_device(self.vectors[start : start + stream_rows], self.device)
            bvals, bidx = topk_ip(q, block, min(k_eff, block.shape[0]))
            bidx = bidx + start
            if vals is None:
                vals, idx = bvals, bidx
            else:
                vals, idx = topk_merge(vals, idx, bvals, bidx, k_eff)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        if k_eff < k:  # pad to requested k like faiss (-1 ids)
            pad = k - k_eff
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        out_ids = np.where(idx >= 0, self._resolve(np.maximum(idx, 0)), -1)
        return vals.astype(np.float32), out_ids.astype(np.int64)

    def range_search(self, queries: np.ndarray, radius: float):
        """faiss-style (lims, D, I): all matches with IP ≥ radius, on the host.

        The corpus is scanned in chunks (like search) — a one-shot fp32
        copy of an mmap'd corpus would materialize 2× the index size in
        host RAM."""
        self._materialize()
        q = np.asarray(queries, np.float32)
        b = q.shape[0]
        n = self.vectors.shape[0]
        ds: list[list[np.ndarray]] = [[] for _ in range(b)]
        is_: list[list[np.ndarray]] = [[] for _ in range(b)]
        for start in range(0, n, _DEVICE_CHUNK):
            block = self.vectors[start : start + _DEVICE_CHUNK].astype(np.float32)
            scores = q @ block.T
            for bi in range(b):
                sel = np.nonzero(scores[bi] >= radius)[0]
                if sel.size:
                    ds[bi].append(scores[bi][sel])
                    is_[bi].append(self._resolve(sel + start))
        lims = [0]
        flat_d, flat_i = [], []
        for bi in range(b):
            cnt = sum(a.size for a in ds[bi])
            lims.append(lims[-1] + cnt)
            flat_d.extend(ds[bi])
            flat_i.extend(is_[bi])
        return (
            np.asarray(lims, np.int64),
            np.concatenate(flat_d) if flat_d else np.zeros((0,), np.float32),
            np.concatenate(flat_i) if flat_i else np.zeros((0,), np.int64),
        )

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        self._materialize()
        if self.ids is not None:
            order = {int(v): i for i, v in enumerate(self.ids)}
            pos = np.asarray([order[int(i)] for i in np.asarray(ids)])
        else:
            pos = np.asarray(ids)
        return self.vectors[pos].astype(np.float32)

    def search_and_reconstruct(self, queries: np.ndarray, k: int):
        vals, ids = self.search(queries, k)
        flat = ids.reshape(-1)
        if self.ntotal == 0:
            return vals, ids, np.zeros((*ids.shape, self.d), np.float32)
        # -1 padding must map to SOME valid id for the batch lookup (rows
        # are zeroed after); with explicit ids, 0 is not necessarily valid
        placeholder = int(self.ids[0]) if self.ids is not None else 0
        safe = np.where(flat >= 0, flat, placeholder)
        recon = self.reconstruct_batch(safe).reshape(*ids.shape, self.d)
        recon[ids < 0] = 0
        return vals, ids, recon

    # -- io ----------------------------------------------------------------

    def save(self, path: str):
        self._materialize()
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump(
                {"type": "flat", "d": self.d, "ntotal": self.ntotal, "metric": "ip", "has_ids": self.ids is not None},
                f,
            )
        np.save(os.path.join(path, "vectors.npy"), self.vectors)
        if self.ids is not None:
            np.save(os.path.join(path, "ids.npy"), self.ids)

    @classmethod
    def load(cls, path: str, mmap: bool = True, device: str | torch.device = "cuda") -> "FlatIndex":
        with open(os.path.join(path, "header.json")) as f:
            header = json.load(f)
        vectors = np.load(os.path.join(path, "vectors.npy"), mmap_mode="r" if mmap else None)
        ids = None
        if header.get("has_ids"):
            ids = np.load(os.path.join(path, "ids.npy"))
        return cls(header["d"], vectors=vectors, ids=ids, device=device)

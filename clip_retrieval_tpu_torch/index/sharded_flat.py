"""Exact int8 brute-force index (the `flat_int8` tier) on one device.

Counterpart of `clip_retrieval_tpu/index/sharded_flat.py::ShardedFlatIndex`,
with the same data arguments, on-disk format (`header.json` of type
`flat_int8`, `q_vectors.npy`, `scales.npy`) and scores: the queries are
quantized with `quantize_rows_device`, the int8 product is exact, scores are
(acc · q_scale) · row_scale, and padding rows (scale 0) are −inf.

What differs from the JAX package: one device, no mesh (multi-GPU is ROADMAP
queue 1, item 13), so the rows live in one device image and a batch scans it
in blocks of `BLOCK_ROWS` with a running top-k merge; top-k is always exact
`torch.topk`, so the JAX constructor's `exact_topk` has no counterpart.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Tuple

import numpy as np
import torch

from ..ops.int8mm import int8_matmul_nt, quantize_rows, quantize_rows_device
from ..ops.topk import topk_merge
from ..utils.device import resolve_device
from .flat import to_device

BLOCK_ROWS = 1 << 20  # DB rows scored per step: bounds the (B, rows) f32 score block


class ShardedFlatIndex:
    """Exact int8 IP index on one device."""

    index_type = "flat_int8"

    def __init__(self, d: int, q_vectors: np.ndarray, scales: np.ndarray, device: str | torch.device = "cuda"):
        self.d = d
        self.q_vectors = q_vectors  # (N, d) int8, may be mmap
        self.scales = scales  # (N,) f32
        self.nprobe = None  # exact index: attribute kept for API parity
        self.device = resolve_device(device)
        self._device = None
        self._device_lock = threading.Lock()

    @property
    def ntotal(self) -> int:
        return int(self.q_vectors.shape[0])

    @classmethod
    def from_vectors(cls, x: np.ndarray, device: str | torch.device = "cuda") -> "ShardedFlatIndex":
        q, s = quantize_rows(x)
        return cls(x.shape[1], q, s, device=device)

    def _ensure_device(self) -> dict:
        with self._device_lock:
            if self._device is None:
                db = torch.empty((self.ntotal, self.d), dtype=torch.int8, device=self.device)
                for a in range(0, self.ntotal, BLOCK_ROWS):
                    db[a : a + BLOCK_ROWS] = to_device(self.q_vectors[a : a + BLOCK_ROWS], self.device)
                self._device = {"db": db, "scale": to_device(np.asarray(self.scales, np.float32), self.device)}
            return self._device

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        b = np.asarray(queries).shape[0]
        if self.ntotal == 0:
            return np.full((b, k), -np.inf, np.float32), np.full((b, k), -1, np.int64)
        dv = self._ensure_device()
        k_eff = min(k, self.ntotal)
        qq, q_scale = quantize_rows_device(to_device(np.asarray(queries, np.float32), self.device))
        vals = idx = None
        for a in range(0, self.ntotal, BLOCK_ROWS):
            db, sc = dv["db"][a : a + BLOCK_ROWS], dv["scale"][a : a + BLOCK_ROWS]
            scores = int8_matmul_nt(qq, db) * q_scale[:, None] * sc[None, :]
            scores = torch.where(sc[None, :] > 0, scores, float("-inf"))  # padding rows
            bvals, bidx = torch.topk(scores, min(k_eff, db.shape[0]), dim=1)
            bidx = bidx + a
            vals, idx = (bvals, bidx) if vals is None else topk_merge(vals, idx, bvals, bidx, k_eff)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy().astype(np.int64)
        idx[~np.isfinite(vals)] = -1
        if k_eff < k:
            vals = np.pad(vals, ((0, 0), (0, k - k_eff)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return vals, idx

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        return self.q_vectors[ids].astype(np.float32) * self.scales[ids][:, None]

    def search_and_reconstruct(self, queries: np.ndarray, k: int):
        vals, ids = self.search(queries, k)
        safe = np.where(ids.reshape(-1) >= 0, ids.reshape(-1), 0)
        recon = self.reconstruct_batch(safe).reshape(*ids.shape, self.d)
        recon[ids < 0] = 0
        return vals, ids, recon

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump({"type": "flat_int8", "d": self.d, "ntotal": self.ntotal, "metric": "ip"}, f)
        np.save(os.path.join(path, "q_vectors.npy"), self.q_vectors)
        np.save(os.path.join(path, "scales.npy"), self.scales)

    @classmethod
    def load(cls, path: str, mmap: bool = True, device: str | torch.device = "cuda") -> "ShardedFlatIndex":
        with open(os.path.join(path, "header.json")) as f:
            h = json.load(f)
        return cls(h["d"], np.load(os.path.join(path, "q_vectors.npy"), mmap_mode="r" if mmap else None),
                   np.load(os.path.join(path, "scales.npy")), device=device)

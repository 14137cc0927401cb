"""Exact int8 brute-force index (the `flat_int8` tier), rows sharded over
devices.

Counterpart of `clip_retrieval_tpu/index/sharded_flat.py::ShardedFlatIndex`,
with the same data arguments, on-disk format (`header.json` of type
`flat_int8`, `q_vectors.npy`, `scales.npy`) and scores: the queries are
quantized with `quantize_rows_device`, the int8 product is exact, scores are
(acc · q_scale) · row_scale, and padding rows (scale 0) are −inf.

Rows are split evenly over `devices` as the JAX tier pads and splits them
over its mesh: shard s owns rows [s·n_shard, (s+1)·n_shard), n_shard =
ceil(N / n_dev).  One process drives every device (FAISS `IndexShards`
serves the same way): each shard scans its rows on its own device in blocks
of `BLOCK_ROWS` with a running top-k and global ids, launched without a
host wait, so shards on different cards run at once; the per-shard (B, k)
candidates are then moved to the first device and merged there, the
counterpart of the JAX tier's `all_gather` and replicated top-k.  Top-k is
always exact `torch.topk`, so the JAX constructor's `exact_topk` has no
counterpart.  No kernel of the port runs here.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.int8mm import int8_matmul_nt, quantize_rows, quantize_rows_device
from ..ops.topk import topk_merge
from ..utils.device import resolve_devices
from .flat import to_device

BLOCK_ROWS = 1 << 20  # DB rows scored per step: bounds the (B, rows) f32 score block


class ShardedFlatIndex:
    """Exact int8 IP index, rows sharded over `devices` (None: every
    visible CUDA device)."""

    index_type = "flat_int8"

    def __init__(self, d: int, q_vectors: np.ndarray, scales: np.ndarray, devices: Sequence | None = None):
        self.d = d
        self.q_vectors = q_vectors  # (N, d) int8, may be mmap
        self.scales = scales  # (N,) f32
        self.nprobe = None  # exact index: attribute kept for API parity
        self.devices = resolve_devices(devices)
        self._shards = None
        self._device_lock = threading.Lock()

    @property
    def ntotal(self) -> int:
        return int(self.q_vectors.shape[0])

    @classmethod
    def from_vectors(cls, x: np.ndarray, devices: Sequence | None = None) -> "ShardedFlatIndex":
        q, s = quantize_rows(x)
        return cls(x.shape[1], q, s, devices=devices)

    def _ensure_device(self) -> list:
        """[(device, first row, db (n_s, d) int8, scales (n_s,) f32)] per
        non-empty shard."""
        with self._device_lock:
            if self._shards is None:
                n_shard = -(-self.ntotal // len(self.devices))
                shards = []
                for s, dev in enumerate(self.devices):
                    lo, hi = s * n_shard, min(self.ntotal, (s + 1) * n_shard)
                    if hi <= lo:  # the shard holds only padding rows
                        continue
                    db = torch.empty((hi - lo, self.d), dtype=torch.int8, device=dev)
                    for a in range(lo, hi, BLOCK_ROWS):
                        db[a - lo : a - lo + BLOCK_ROWS] = to_device(self.q_vectors[a : min(hi, a + BLOCK_ROWS)], dev)
                    shards.append((dev, lo, db, to_device(np.asarray(self.scales[lo:hi], np.float32), dev)))
                self._shards = shards
            return self._shards

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        b = np.asarray(queries).shape[0]
        if self.ntotal == 0:
            return np.full((b, k), -np.inf, np.float32), np.full((b, k), -1, np.int64)
        shards = self._ensure_device()
        k_eff = min(k, self.ntotal)
        qq, q_scale = quantize_rows_device(to_device(np.asarray(queries, np.float32), self.devices[0]))
        cands = []
        for dev, lo, db_s, sc_s in shards:
            qq_s, qs_s = qq.to(dev, non_blocking=True), q_scale.to(dev, non_blocking=True)
            vals = idx = None
            for a in range(0, db_s.shape[0], BLOCK_ROWS):
                db, sc = db_s[a : a + BLOCK_ROWS], sc_s[a : a + BLOCK_ROWS]
                scores = int8_matmul_nt(qq_s, db) * qs_s[:, None] * sc[None, :]
                scores = torch.where(sc[None, :] > 0, scores, float("-inf"))  # padding rows
                bvals, bidx = torch.topk(scores, min(k_eff, db.shape[0]), dim=1)
                bidx = bidx + (lo + a)
                vals, idx = (bvals, bidx) if vals is None else topk_merge(vals, idx, bvals, bidx, k_eff)
            cands.append((vals, idx))
        first = self.devices[0]
        vals = torch.cat([v.to(first) for v, _ in cands], dim=1)
        idx = torch.cat([i.to(first) for _, i in cands], dim=1)
        vals, pos = torch.topk(vals, k_eff, dim=1)
        vals, idx = vals.cpu().numpy(), torch.gather(idx, 1, pos).cpu().numpy().astype(np.int64)
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
    def load(cls, path: str, mmap: bool = True, devices: Sequence | None = None) -> "ShardedFlatIndex":
        with open(os.path.join(path, "header.json")) as f:
            h = json.load(f)
        return cls(h["d"], np.load(os.path.join(path, "q_vectors.npy"), mmap_mode="r" if mmap else None),
                   np.load(os.path.join(path, "scales.npy")), devices=devices)

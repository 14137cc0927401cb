"""List-sharded IVF-int8: the ivf_int8 format served over several devices.

Counterpart of `clip_retrieval_tpu/index/sharded_ivf.py::ShardedIVFInt8Index`.
The inverted lists are split over `devices` as the JAX tier splits them over
its mesh: shard s owns lists [s·ls, (s+1)·ls), ls = ceil(nlist / n_dev), with
their coarse centroids and their chunked CSR image (`build_chunked_image`)
on its device.  A query batch goes to every shard; each shard probes its own
top-nprobe lists, so the union scanned over all shards contains the global
top-nprobe lists and recall is at least the one-device tier's.  Each shard
scans its probed union with kernel K3 (`int8_gather_scan`) on its device and
keeps its local top-k with global CSR positions; the per-shard (B, k)
candidates are moved to the first device and merged there (the JAX tier's
`all_gather` and replicated top-k).  One process drives every device, as
FAISS `IndexShards` does; launches are asynchronous, so shards on different
cards run at once.  The disk format is unchanged ivf_int8.

The three union routes of the one-device tier, per shard: "exact" reads the
per-shard probed lists back and scans exactly their chunks, "device" scans
an adaptive cap shared by the shards in one dispatch and runs the batch
again when a shard's union overflowed it, "static" scans the worst-case
budget; "auto" takes `resolve_union`'s measured choice (exact).

What differs from the JAX tier:
- a shard holds only its real lists (the last shards may hold fewer, a shard
  with no rows is left out), so no padding list exists that a probe could
  pick; the JAX tier pads every shard to ls lists and masks the padding ones
  with a validity vector;
- each shard's image carries its own all-padding chunk, which pads its
  exact-route selection to the cap the shards share (the JAX tier pads every
  image to the largest shard's chunk count);
- the scan is K3 on every route, where the JAX tier gathers rows and takes a
  `dot_general` outside Pallas; top-k is exact `torch.topk`;
- `last_union_chunks` is an int on every route (the largest per-shard
  probed union), the route rides in the dispatch handle, a batch's result
  reads back in one transfer, and `overflow_redispatches` counts re-runs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_devices
from .ivf_int8 import (
    IVFInt8Index,
    _chunk_len,
    _next_pow2,
    _quarter_pow2,
    _readback,
    _scan_topk,
    _search_device,
    build_chunked_image,
    chunk_budget,
    select_probes,
    union_chunk_sel,
)


def _merge(cands: list, k: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the shards' (vals, positions) candidates, on `device`."""
    vals = torch.cat([v.to(device) for v, _ in cands], dim=1)
    pos = torch.cat([p.to(device) for _, p in cands], dim=1)
    mvals, midx = torch.topk(vals, min(k, vals.shape[1]), dim=1)
    return mvals, torch.gather(pos, 1, midx)


class ShardedIVFInt8Index(IVFInt8Index):
    """IVF-int8 with its inverted lists sharded over `devices` (None: every
    visible CUDA device; a device may repeat)."""

    def __init__(self, *args, devices: Sequence | None = None, **kwargs):
        self.devices = resolve_devices(devices)
        super().__init__(*args, device=self.devices[0], **kwargs)
        self._shards: list = []

    # -- device image --------------------------------------------------------

    def _ensure_device(self):
        with self._device_lock:
            if self._device is not None:
                return
            if self.ntotal >= np.iinfo(np.int32).max:
                raise ValueError(
                    f"ivf_int8 device image supports < 2^31 rows per index (got {self.ntotal}); shard the corpus"
                )
            n_dev = len(self.devices)
            ls = -(-max(self.nlist, n_dev) // n_dev)  # lists per shard
            lc = _chunk_len(self.ntotal, self.nlist)
            counts = -(-self.list_sizes() // lc)
            # one shard at a time, each image built on its device from blocks
            # of the host rows: the host never holds a chunked copy
            shards = []
            for s, dev in enumerate(self.devices):
                lo, hi = s * ls, min(self.nlist, (s + 1) * ls)
                nc = int(counts[lo:hi].sum()) if hi > lo else 0
                if nc == 0:  # no lists, or only empty ones: nothing to scan
                    continue
                img = build_chunked_image(self.q_vectors, self.scales, self.list_offsets, lc, lo=lo, hi=hi,
                                          pad_chunks=nc + 1, device=dev)
                img["coarse"] = torch.from_numpy(self.coarse_centroids[lo:hi]).to(dev)
                castarts = np.zeros(hi - lo, np.int64)
                np.cumsum(counts[lo : hi - 1], out=castarts[1:])
                # the extra chunk at index nc is all padding: it pads the
                # exact route's selection buckets
                shards.append({"dev": dev, "img": img, "counts": counts[lo:hi], "castarts": castarts,
                               "pad_chunk": nc})
            self._device = self._shards = shards

    def _union_expect_chunks(self, padded_b: int, p: int) -> float:
        """The one-device expectation per shard (each probes its own top-p of
        its lists); the shared cap must cover the largest."""
        best = 0.0
        for sh in self._shards:
            nl = sh["counts"].size
            exp_lists = nl * (1.0 - (1.0 - 1.0 / nl) ** (padded_b * p))
            best = max(best, exp_lists * float(sh["counts"].mean()) * 1.25)
        return best

    def _union_worst_chunks(self, padded_b: int, p: int) -> int:
        return max(chunk_budget(sh["counts"], padded_b * p) for sh in self._shards)

    # -- search --------------------------------------------------------------

    def _search_device_shards(self, qs: list, k_dev: int, p: int, u_cap: int):
        """One dispatch per shard of the single-dispatch search, merged on
        the first device: (vals, positions, largest per-shard union)."""
        cands, unions = [], []
        for q, sh in zip(qs, self._shards):
            vals, pos, n_union = _search_device(q, sh["img"], k_dev, min(p, sh["counts"].size), u_cap)
            cands.append((vals, pos))
            unions.append(n_union.to(self.device))
        vals, pos = _merge(cands, k_dev, self.device)
        return vals, pos, torch.stack(unions).max()

    def _search_int8_dispatch(self, queries: np.ndarray, k: int) -> dict:
        b_in = np.asarray(queries).shape[0]
        if self.ntotal == 0:
            return {"mode": "empty", "b": b_in, "k": k}
        self._ensure_device()
        p = min(self.nprobe, self.nlist)
        q, b = self._pad_queries_pow2(queries)
        q0 = torch.from_numpy(q).to(self.device)
        qs = [q0.to(sh["dev"], non_blocking=True) for sh in self._shards]
        k_dev = min(k, self.ntotal)
        mode = self.resolve_union(q.shape[0])
        h = {"mode": mode, "qs": qs, "p": p, "b": b, "k": k, "k_dev": k_dev}
        if mode == "exact":
            h["per_q"] = [select_probes(torch.matmul(qd, sh["img"]["coarse"].T), p)
                          for qd, sh in zip(qs, self._shards)]
            return h
        if mode == "device":
            u_cap = self._device_union_cap(q.shape[0], p)
        else:  # static: a budget covering the worst possible union of this padded batch on any shard
            u_cap = _next_pow2(self._union_worst_chunks(q.shape[0], p))
        h["vals"], h["pos"], h["n_union"] = self._search_device_shards(qs, k_dev, p, u_cap)
        h["u_cap"] = u_cap
        return h

    def _search_int8_finish(self, h: dict) -> Tuple[np.ndarray, np.ndarray]:
        if h["mode"] == "empty":
            return np.full((h["b"], h["k"]), -np.inf, np.float32), np.full((h["b"], h["k"]), -1, np.int64)
        if h["mode"] == "exact":
            # the shards' probed lists in one read-back, then each shard
            # scans exactly its own union through K3
            per_q = torch.cat([pq.to(self.device) for pq in h["per_q"]], dim=1).cpu().numpy()
            per_q = np.split(per_q, np.cumsum([pq.shape[1] for pq in h["per_q"]])[:-1], axis=1)
            unions = [int(sh["counts"][np.unique(pq)].sum()) for pq, sh in zip(per_q, self._shards)]
            self.last_union_chunks = max(unions)
            # one ¼-pow2 cap for every shard, as the JAX tier sizes it: a
            # shard whose whole image fits under it scans all of its chunks
            cap = min(_quarter_pow2(max(self.last_union_chunks, 16)), max(sh["pad_chunk"] for sh in self._shards))
            cands = []
            for qd, sh, pq in zip(h["qs"], self._shards, per_q):
                sel, _ = union_chunk_sel(pq, sh["counts"], sh["castarts"], sh["pad_chunk"], cap)
                cands.append(_scan_topk(qd, sh["img"], torch.from_numpy(sel).to(sh["dev"]), h["k_dev"]))
            vals, pos = _readback(*_merge(cands, h["k_dev"], self.device))
        else:
            vals, pos, n_union = _readback(h["vals"], h["pos"], h["n_union"])
            n_union = int(n_union)
            self.last_union_chunks = n_union
            if h["mode"] == "device" and n_union > h["u_cap"]:
                # a shard's union overflowed the shared cap: grow it and run
                # the batch again on every shard
                self.overflow_redispatches += 1
                u_cap = self._grow_device_cap(h["qs"][0].shape[0], h["p"], n_union)
                vals, pos, _ = _readback(*self._search_device_shards(h["qs"], h["k_dev"], h["p"], u_cap))
        return self._finish_ids(vals, pos, h["b"], h["k"])

    # -- io --------------------------------------------------------------

    @classmethod
    def load(cls, path: str, mmap: bool = True, devices: Sequence | None = None) -> "ShardedIVFInt8Index":
        # the one-device loader reads the header, so the format has one reader
        devices = resolve_devices(devices)
        return cls.from_index(IVFInt8Index.load(path, mmap=mmap, device=devices[0]), devices=devices)

    @classmethod
    def from_vectors(cls, x: np.ndarray, nlist: int, devices: Sequence | None = None,
                     **kwargs) -> "ShardedIVFInt8Index":
        """`IVFInt8Index.from_vectors` (k-means on the first device), sharded."""
        devices = resolve_devices(devices)
        return cls.from_index(IVFInt8Index.from_vectors(x, nlist, device=devices[0], **kwargs), devices=devices)

    @classmethod
    def from_index(cls, ivf: IVFInt8Index, devices: Sequence | None = None) -> "ShardedIVFInt8Index":
        return cls(
            ivf.d,
            ivf.coarse_centroids,
            ivf.list_offsets,
            ivf.list_ids,
            ivf.q_vectors,
            ivf.scales,
            nprobe=ivf.nprobe,
            exact_topk=ivf.exact_topk,
            refine_vectors=ivf.refine_vectors,
            rerank_factor=ivf.rerank_factor,
            union=ivf.union,
            devices=devices,
        )

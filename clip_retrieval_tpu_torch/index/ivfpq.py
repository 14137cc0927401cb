"""IVF-PQ index: coarse lists, PQ codes of the residuals, ADC search on kernel K4.

Counterpart of `clip_retrieval_tpu/index/ivfpq.py`, with the same
constructor, the same on-disk directory and header (an index either package
saves loads in the other) and the same search semantics.  Layout:

  coarse_centroids (nlist, d)      rotated space
  codebooks        (M, 256, dsub)  PQ on residuals (by_residual)
  rotation         (d, d) or None  OPQ: x_rot = x @ R
  list_offsets     (nlist+1,)      CSR offsets into the two below
  list_ids         (N,)            original vector ids, grouped by list
  list_codes       (N, M) uint8    PQ codes, grouped by list

Device search (an index whose codes fit the device, see `_device_room`):
  1. the codes are staged once with every list start aligned to the K4
     chunk C = 128 (the codes plus ≤ nlist·C pad rows, never an (nlist, Lmax)
     image);
  2. one product + top-k picks each query's nprobe lists by q·c
     (`ivf_int8.select_probes`, the rule of both IVF tiers); each query owns a
     budget of chunks, probe p of query b covering a contiguous range of it,
     and the (B·budget) chunk worklist is scored by K4 against the queries'
     (B, M, 256) f32 ADC tables plus the q·centroid coarse term;
  3. an exact top-k over each query's slots, mapped back to CSR positions,
     and to ids on the host.
  The chunk budget is the static worst case (the nprobe largest lists) —
  one dispatch, no read-back before the scan — up to 2^26 score slots a
  batch, and per-query power-of-two buckets past that, after one read-back
  of the (B,) probed chunk totals (`_budget_route`, set from the route sweep
  on the H100: the static budget won at every batch of 1-256 even on skewed
  lists, where most of its chunks are empty).
Indices that do not fit scan on the host through the C++ scanner
(`native/adc_scan.cpp`), or numpy where no compiler exists; an index that
fits always searches on the device, which the route sweep found 15-80x
faster than the host scan at every batch size of 1-256 on the H100.

What differs from the JAX package: every device route scores through K4 on
CUDA (its plain version on the CPU), so `CRT_IVFPQ_SCORER`/`_pick_scorer`
and the windowed XLA scan `_scan_device` have no counterpart (the JAX
package's exact-f32 `_scan_device` is what the tests hold this index to);
no 128-query split of a batch and no power-of-two batch padding (both served
the MXU and XLA's compile cache); the device-memory budget is measured on the
card when the codes are staged, not a fixed figure.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Tuple

import numpy as np
import torch

from ..ops.adc_scan import CHUNK as _ALIGN
from ..ops.adc_scan import adc_scan
from ..ops.pq import PQCodebooks, adc_lut
from ..utils.device import resolve_device
from .flat import to_device
from .ivf_int8 import _UPLOAD_ROWS, _next_pow2, _readback, select_probes

LOGGER = logging.getLogger("clip_back")
_SCAN_RESERVE = 2 << 30  # bytes left beside the codes for the scan's transients (≤ 1 GiB of scores per dispatch)
# score slots (B · static chunk budget · C) up to which a batch takes the static budget: the largest worklist of the
# route sweep (tools/sweep_routes.py, H100 80GB HBM3 at 700 W), which found it ahead of the buckets or level with them
_STATIC_SLOTS_MAX = 1 << 26
_SLOTS_PER_DISPATCH = 1 << 28  # bound on B·budget·C score slots of one K4 dispatch (1 GiB of f32)


def _budget_buckets(totals: np.ndarray, floor: int) -> dict[int, np.ndarray]:
    """Group query indices by the power-of-2 budget ≥ each query's probed
    total (at least `floor`)."""
    budgets = np.maximum(np.asarray(totals, np.int64), floor)
    budgets = np.int64(1) << np.int64(np.ceil(np.log2(budgets.astype(np.float64))))
    return {int(bud): np.nonzero(budgets == bud)[0] for bud in np.unique(budgets)}


def _device_room(device: torch.device) -> int:
    """Bytes the staged codes may take on `device`: what is free now (the
    card's free memory; on the CPU the host's available memory) less the
    scan's reserve."""
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return free - _SCAN_RESERVE


def probe(qr: torch.Tensor, coarse: torch.Tensor, nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's nprobe lists and their q·c coarse terms:
    (probe_vals (B, P) f32, probe_idx (B, P) int64)."""
    scores = qr @ coarse.T
    probe_idx = select_probes(scores, nprobe)
    return scores.gather(1, probe_idx), probe_idx


def _worklist(qr: torch.Tensor, probe_vals: torch.Tensor, probe_idx: torch.Tensor, dv: dict, nchunk_q: int):
    """K4's arguments for a budget of nchunk_q chunks per query, probe p of
    query b covering a contiguous range of b's budget; also (seg, padcum):
    the probe owning each chunk and each probe's first chunk."""
    c = _ALIGN
    b = qr.shape[0]
    dev = qr.device
    psizes = dv["sizes"][probe_idx]  # (B, P)
    pchunks = (psizes + c - 1) // c
    padcum = torch.cumsum(pchunks, dim=1) - pchunks
    j = torch.arange(nchunk_q, device=dev).expand(b, nchunk_q).contiguous()
    # the probe owning chunk j: the last one starting at or before j (empty lists are skipped;
    # chunks past the total land on the last probe with nvalid 0)
    seg = torch.searchsorted(padcum.contiguous(), j, right=True) - 1
    within = j - padcum.gather(1, seg)
    nvalid = (psizes.gather(1, seg) - within * c).clamp(0, c)
    blocks = torch.where(nvalid > 0, (dv["astarts"][probe_idx] // c).gather(1, seg) + within, 0)
    owner = torch.arange(b, device=dev)[:, None].expand(b, nchunk_q)
    args = (dv["codes"], adc_lut(qr, dv["codebooks"]).contiguous(), blocks.reshape(-1).int(),
            nvalid.reshape(-1).int(), owner.reshape(-1).int(), probe_vals.gather(1, seg).reshape(-1).contiguous())
    return args, seg, padcum


def _search_chunks(qr: torch.Tensor, probe_vals: torch.Tensor, probe_idx: torch.Tensor, dv: dict, k: int,
                   nchunk_q: int):
    """Score each query's nchunk_q-chunk budget through K4 and take the
    exact top-k: (vals (B, k') f32, CSR positions (B, k') int64, −1 where
    vals is −inf), k' = min(k, nchunk_q·C)."""
    c = _ALIGN
    args, seg, padcum = _worklist(qr, probe_vals, probe_idx, dv, nchunk_q)
    out = adc_scan(*args)  # (B·nchunk_q, C)
    vals, slots = torch.topk(out.reshape(qr.shape[0], nchunk_q * c), min(k, nchunk_q * c), dim=1)
    win_j = slots // c
    win_seg = seg.gather(1, win_j)
    rows = dv["starts"][probe_idx].gather(1, win_seg) + (win_j - padcum.gather(1, win_seg)) * c + slots % c
    return vals, torch.where(torch.isfinite(vals), rows, -1)


class IVFPQIndex:
    index_type = "ivfpq"

    def __init__(
        self,
        d: int,
        coarse_centroids: np.ndarray,
        codebooks: np.ndarray,
        rotation: np.ndarray | None,
        list_offsets: np.ndarray,
        list_ids: np.ndarray,
        list_codes: np.ndarray,
        nprobe: int = 16,
        refine_vectors: np.ndarray | None = None,
        rerank_factor: int = 4,
        device: str | torch.device = "cuda",
    ):
        self.d = d
        self.coarse_centroids = np.asarray(coarse_centroids, np.float32)
        self.codebooks = np.asarray(codebooks, np.float32)
        self.rotation = None if rotation is None else np.asarray(rotation, np.float32)
        self.list_offsets = np.asarray(list_offsets, np.int64)
        self.list_ids = list_ids  # may be mmap
        self.list_codes = list_codes  # may be mmap
        self.nprobe = nprobe
        # optional exact re-ranking over the original fp16 rows (id order):
        # ADC selects rerank_factor·k candidates, the true vectors re-score them
        self.refine_vectors = refine_vectors
        self.rerank_factor = rerank_factor
        self.device = resolve_device(device)
        self._device = None
        self._on_device = None  # decided when the codes are first searched (`_fits_device`)
        self._device_lock = threading.Lock()
        self._id_to_pos = None
        self._chunks_desc_cumsum = None

    # -- basic props -------------------------------------------------------

    @property
    def nlist(self) -> int:
        return self.coarse_centroids.shape[0]

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ntotal(self) -> int:
        return int(self.list_ids.shape[0])

    @property
    def pq(self) -> PQCodebooks:
        rot = None if self.rotation is None else torch.from_numpy(self.rotation).to(self.device)
        return PQCodebooks(codebooks=torch.from_numpy(self.codebooks).to(self.device), rotation=rot)

    def list_sizes(self) -> np.ndarray:
        return np.diff(self.list_offsets)

    # -- device image ------------------------------------------------------

    def _device_bytes(self) -> int:
        """Device memory of the codes image: the codes plus ≤ nlist·C pad rows."""
        return (self.ntotal + self.nlist * _ALIGN) * self.m

    def _fits_device(self) -> bool:
        """Whether search runs on the device: decided once, against the
        memory free on it when the codes would be staged.  An index that
        does not fit searches on the host, which is logged on a card."""
        with self._device_lock:
            if self._on_device is None:
                need, room = self._device_bytes(), _device_room(self.device)
                self._on_device = self._device is not None or need <= room
                if not self._on_device and self.device.type == "cuda":
                    LOGGER.warning("IVF-PQ codes need %.2f GB on %s, %.2f GB is free beside the scan's reserve: "
                                   "searching on the host", need / 1e9, self.device, room / 1e9)
            return self._on_device

    def _ensure_device(self) -> dict:
        """Stage the CSR codes on the device with every list start aligned
        to C, scattered from blocks of host rows (no host copy of the aligned
        image), plus the small per-list arrays.  Locked: searches on several
        batcher threads must not each build it."""
        with self._device_lock:
            if self._device is not None:
                return self._device
            dev = self.device
            sizes = self.list_sizes().astype(np.int64)
            csr_starts = self.list_offsets[:-1].astype(np.int64)
            chunk_sizes = -(-sizes // _ALIGN)
            pad_sizes = chunk_sizes * _ALIGN
            astarts = np.zeros(self.nlist, np.int64)
            np.cumsum(pad_sizes[:-1], out=astarts[1:])
            n_aligned = max(int(astarts[-1] + pad_sizes[-1]) if self.nlist else 0, _ALIGN)
            codes = torch.zeros((n_aligned, self.m), dtype=torch.uint8, device=dev)
            # image row of CSR row r (list l) = astart[l] + (r − csr_start[l])
            dst = np.repeat(astarts - csr_starts, sizes) + np.arange(self.ntotal, dtype=np.int64)
            for a in range(0, self.ntotal, _UPLOAD_ROWS):
                b = min(a + _UPLOAD_ROWS, self.ntotal)
                codes.index_copy_(0, torch.from_numpy(dst[a:b]).to(dev), to_device(self.list_codes[a:b], dev))
            tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
            self._device = {
                "coarse": tensor(self.coarse_centroids),
                "codebooks": tensor(self.codebooks),
                "rotation": None if self.rotation is None else tensor(self.rotation),
                "codes": codes,
                "astarts": tensor(astarts),
                "starts": tensor(csr_starts),
                "sizes": tensor(sizes),
                "csizes": tensor(chunk_sizes),
            }
            return self._device

    # -- search ------------------------------------------------------------

    def _rotate(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, np.float32)
        return q if self.rotation is None else q @ self.rotation

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.refine_vectors is not None and self.rerank_factor > 1:
            from .rerank import exact_rerank

            _, ids = self._search_adc(queries, k * self.rerank_factor)
            return exact_rerank(self.refine_vectors, queries, ids, k)
        return self._search_adc(queries, k)

    def _search_adc(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.ntotal == 0:
            b = np.asarray(queries).shape[0]
            return np.full((b, k), -np.inf, np.float32), np.full((b, k), -1, np.int64)
        nprobe = min(self.nprobe, self.nlist)
        if self._fits_device():
            return self._search_device(queries, k, nprobe)
        return self._search_host(queries, k, nprobe)

    def _static_chunk_budget(self, nprobe: int) -> int:
        """Worst-case probed chunks: the nprobe largest ceil(size/C)."""
        if self._chunks_desc_cumsum is None:
            self._chunks_desc_cumsum = np.cumsum(np.sort(-(-self.list_sizes() // _ALIGN))[::-1])
        return int(self._chunks_desc_cumsum[min(nprobe, self.nlist) - 1])

    def _static_nchunk_q(self, nprobe: int) -> int:
        """Chunks per query of the static budget: the worst case to a power
        of two, at least 8."""
        return _next_pow2(max(self._static_chunk_budget(nprobe), 8))

    def _budget_route(self, nprobe: int, b: int) -> str:
        """"static" (one budget for every query, no read-back before the
        scan) or "buckets" (per-query budgets after one read-back of the
        probed totals) for a batch of b queries at nprobe.  On the H100 the
        static budget won at every batch of B 1-256 in two runs of the route
        sweep, on skewed lists whose static budget is ~75 % empty chunks, by
        0.1-2.7 ms of a search batch, but for one tie (0.09 ms at B=256,
        nprobe 32).  A batch takes the static budget up to the sweep's
        largest worklist (`_STATIC_SLOTS_MAX` score slots), the buckets past
        it, where no measurement reaches."""
        return "static" if b * self._static_nchunk_q(nprobe) * _ALIGN <= _STATIC_SLOTS_MAX else "buckets"

    def _chunk_buckets(self, dv: dict, probe_idx: torch.Tensor, nprobe: int) -> tuple[dict[int, np.ndarray], bool]:
        """(chunk budget → the queries scanned with it, bucketed): one static
        budget for every query, or per-query power-of-two buckets (after one
        read-back of the probed totals), as `_budget_route` picks."""
        if self._budget_route(nprobe, probe_idx.shape[0]) == "buckets":
            totals = dv["csizes"][probe_idx].sum(dim=1).cpu().numpy()
            return _budget_buckets(totals, 8), True
        return {self._static_nchunk_q(nprobe): np.arange(probe_idx.shape[0])}, False

    def _search_device(self, queries: np.ndarray, k: int, nprobe: int) -> Tuple[np.ndarray, np.ndarray]:
        """Chunk-worklist ADC scan on the device (see module docstring)."""
        dv = self._ensure_device()
        qr = to_device(np.asarray(queries, np.float32), self.device)
        if dv["rotation"] is not None:
            qr = qr @ dv["rotation"]
        b = qr.shape[0]
        probe_vals, probe_idx = probe(qr, dv["coarse"], nprobe)
        buckets, _ = self._chunk_buckets(dv, probe_idx, nprobe)
        pending = []
        for nchunk_q, sel in buckets.items():
            step = max(1, _SLOTS_PER_DISPATCH // (nchunk_q * _ALIGN))
            for s in range(0, len(sel), step):
                sub = sel[s : s + step]
                idx = torch.from_numpy(sub).to(self.device)
                pending.append((sub, _search_chunks(qr[idx], probe_vals[idx], probe_idx[idx], dv, k, nchunk_q)))
        # every dispatch is enqueued before the first read-back
        vals = np.full((b, k), -np.inf, np.float32)
        rows = np.full((b, k), -1, np.int64)
        for sub, (v, r) in pending:
            v, r = _readback(v, r)
            vals[sub, : v.shape[1]] = v
            rows[sub, : r.shape[1]] = r
        # CSR positions → original ids on the host (ids may exceed int32)
        ids_arr = np.asarray(self.list_ids)
        ids = np.where(rows >= 0, ids_arr[np.where(rows >= 0, rows, 0)], -1)
        return vals, ids

    def _search_host(self, queries: np.ndarray, k: int, nprobe: int):
        """Host scan over the CSR arrays (mmap-friendly): one batched call
        into the C++ OpenMP scanner (`adc_search_batch`, per-query top-k
        heaps) when it builds, a numpy gather loop otherwise."""
        from ..native import get_adc_lib

        qr = self._rotate(queries)
        coarse_scores = qr @ self.coarse_centroids.T  # (B, nlist)
        probe_idx = select_probes(torch.from_numpy(coarse_scores), nprobe).numpy()
        m, ksub, dsub = self.codebooks.shape
        lut_all = np.ascontiguousarray(
            np.einsum("bmd,mkd->bmk", qr.reshape(qr.shape[0], m, dsub), self.codebooks), np.float32
        )  # (B, M, ksub)
        lib = get_adc_lib() if ksub == 256 else None
        codes_arr = np.asarray(self.list_codes)
        ids_arr = np.asarray(self.list_ids)
        nq = qr.shape[0]
        out_vals = np.full((nq, k), -np.inf, np.float32)
        out_ids = np.full((nq, k), -1, np.int64)
        if lib is not None:
            probes = np.ascontiguousarray(probe_idx, np.int32)
            coarse = np.ascontiguousarray(np.take_along_axis(coarse_scores, probe_idx, axis=1), np.float32)
            lib.adc_search_batch(codes_arr, ids_arr, self.list_offsets, probes, nprobe, lut_all, m, coarse, nq, k,
                                 out_vals, out_ids)
            return out_vals, out_ids
        sizes = self.list_sizes()
        for b in range(nq):
            probes = probe_idx[b]
            if int(sizes[probes].sum()) == 0:
                continue
            scores_all, ids_all = [], []
            lut = lut_all[b]
            for li in probes:
                s, e = self.list_offsets[li], self.list_offsets[li + 1]
                if e <= s:
                    continue
                part = lut[np.arange(m)[None, :], codes_arr[s:e].astype(np.int64)].sum(axis=1)
                scores_all.append((part + coarse_scores[b, li]).astype(np.float32))
                ids_all.append(ids_arr[s:e])
            sc = np.concatenate(scores_all)
            ids = np.concatenate(ids_all)
            kk = min(k, sc.size)
            top = np.argpartition(-sc, kk - 1)[:kk]
            order = top[np.argsort(-sc[top])]
            out_vals[b, :kk] = sc[order]
            out_ids[b, :kk] = ids[order]
        return out_vals, out_ids

    # -- reconstruction ----------------------------------------------------

    def _positions(self, ids: np.ndarray) -> np.ndarray:
        if self._id_to_pos is None:
            all_ids = np.asarray(self.list_ids)
            order = np.argsort(all_ids, kind="stable")
            self._id_to_pos = (all_ids[order], order)
        sorted_ids, order = self._id_to_pos
        pos = np.clip(np.searchsorted(sorted_ids, ids), 0, len(order) - 1)
        missing = sorted_ids[pos] != ids
        if missing.any():
            # silent wrong reconstructions would poison dedup/safety filtering
            raise KeyError(f"ids not in index: {np.asarray(ids)[missing][:8].tolist()}")
        return order[pos]

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        """PQ-decode stored vectors for the given original ids, on the host."""
        pos = self._positions(np.asarray(ids, np.int64))
        codes = np.asarray(self.list_codes)[pos].astype(np.int64)
        list_of_pos = np.searchsorted(self.list_offsets, pos, side="right") - 1  # each position's list (residual add)
        resid = self.codebooks[np.arange(self.m)[None, :], codes].reshape(len(pos), -1)
        xr = resid + self.coarse_centroids[list_of_pos]
        if self.rotation is not None:
            xr = xr @ self.rotation.T
        return xr.astype(np.float32)

    def search_and_reconstruct(self, queries: np.ndarray, k: int):
        vals, ids = self.search(queries, k)
        flat = ids.reshape(-1)
        # fill invalid (-1) slots with a real id so _positions can't raise
        fill = int(np.asarray(self.list_ids[:1])[0]) if self.ntotal else 0
        safe = np.where(flat >= 0, flat, fill)
        recon = self.reconstruct_batch(safe).reshape(*ids.shape, self.d)
        recon[ids < 0] = 0
        return vals, ids, recon

    # -- io ----------------------------------------------------------------

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump(
                {
                    "type": "ivfpq",
                    "d": self.d,
                    "ntotal": self.ntotal,
                    "metric": "ip",
                    "nlist": self.nlist,
                    "m": self.m,
                    "ksub": int(self.codebooks.shape[1]),
                    "use_opq": self.rotation is not None,
                    "nprobe": self.nprobe,
                    "has_refine": self.refine_vectors is not None,
                    "rerank_factor": self.rerank_factor,
                },
                f,
            )
        np.save(os.path.join(path, "coarse_centroids.npy"), self.coarse_centroids)
        np.save(os.path.join(path, "codebooks.npy"), self.codebooks)
        if self.rotation is not None:
            np.save(os.path.join(path, "rotation.npy"), self.rotation)
        np.save(os.path.join(path, "list_offsets.npy"), self.list_offsets)
        np.save(os.path.join(path, "list_ids.npy"), np.asarray(self.list_ids))
        np.save(os.path.join(path, "list_codes.npy"), np.asarray(self.list_codes))
        if self.refine_vectors is not None:
            from .rerank import save_rows_fp16

            # streams: the store may be a ShardRowGather or a memmap
            save_rows_fp16(os.path.join(path, "refine_vectors.npy"), self.refine_vectors)

    @classmethod
    def load(cls, path: str, mmap: bool = True, device: str | torch.device = "cuda") -> "IVFPQIndex":
        with open(os.path.join(path, "header.json")) as f:
            h = json.load(f)
        mm = "r" if mmap else None
        rotation = np.load(os.path.join(path, "rotation.npy")) if h.get("use_opq") else None
        refine = np.load(os.path.join(path, "refine_vectors.npy"), mmap_mode=mm) if h.get("has_refine") else None
        return cls(
            d=h["d"],
            coarse_centroids=np.load(os.path.join(path, "coarse_centroids.npy")),
            codebooks=np.load(os.path.join(path, "codebooks.npy")),
            rotation=rotation,
            list_offsets=np.load(os.path.join(path, "list_offsets.npy")),
            list_ids=np.load(os.path.join(path, "list_ids.npy"), mmap_mode=mm),
            list_codes=np.load(os.path.join(path, "list_codes.npy"), mmap_mode=mm),
            nprobe=h.get("nprobe", 16),
            refine_vectors=refine,
            rerank_factor=h.get("rerank_factor", 4),
            device=device,
        )

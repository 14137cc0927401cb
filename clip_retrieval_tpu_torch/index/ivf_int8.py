"""IVF-pruned int8 index: coarse pruning + int8 scan of the probed lists.

Counterpart of `clip_retrieval_tpu/index/ivf_int8.py`, with the same
constructor, the same on-disk format (an index either package saves loads in
the other) and the same search semantics:

- rows are grouped by IVF list in a **chunked CSR image**: every list
  occupies ceil(size/Lc) chunks of Lc rows in one (nchunks, Lc, d) int8
  array on the device, plus one all-padding chunk at the end;
- coarse scores are one (B, d)×(d, nlist) product; each query picks its own
  top-nprobe lists and the batch scans the **union** of everyone's lists
  with one int8 product (extra union lists only add candidates);
- union sizing: "exact" reads the probed lists back and scans exactly their
  chunks (¼-pow2 bucketed, padded with the all-padding chunk); "static"
  scans the worst-case budget in one dispatch; "device" scans an adaptive
  cap in one dispatch and re-dispatches when the union overflowed it;
  "auto" takes exact at every batch size (`resolve_union`: the route sweep
  on the H100 found it the fastest at B 1-64; the JAX package takes static
  for a single query);
- the scan is kernel K3 (`ops/int8scan.py::int8_gather_scan`) in every mode:
  the host-built selection in exact mode, the chunks picked on the device
  from the chunk scores in static and device modes.

What differs from the JAX package:
- top-k is always exact `torch.topk`: PyTorch has no `approx_max_k`, so the
  port never takes the approximate route (`exact_topk` is kept for
  constructor compatibility and changes nothing);
- the chunk selection of static/device modes takes ties in index order, as
  `jax.lax.top_k` does, by a stable sort;
- the union route is a function of the batch (`resolve_union`) carried in
  the dispatch handle, not a mutable attribute; `last_union_chunks` is an
  int in every mode; a device-mode batch reads vals, ids and the union size
  back in one transfer; `overflow_redispatches` counts re-dispatches;
- `build_chunked_image` builds the image on the device from blocks of the
  host rows, so the host never holds a second, chunked copy of the corpus;
- `from_vectors` trains and assigns with the port's k-means on `device`.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Tuple

import numpy as np
import torch

from ..ops.int8mm import quantize_rows, quantize_rows_device
from ..ops.int8scan import int8_gather_scan
from ..utils.device import resolve_device
from .flat import to_device

_UPLOAD_ROWS = 1 << 18  # CSR rows per host→device block of the chunked image


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _quarter_pow2(n: int) -> int:
    """Smallest m·2^e ≥ n with mantissa m ∈ {4,5,6,7}: ≤25 % over-
    provisioning (plain pow2 wastes up to 2×) at ~4× the shape count."""
    if n <= 4:
        return max(1, int(n))
    p = _next_pow2(n)
    for m in (4, 5, 6, 7):
        c = (p // 8) * m
        if c >= n:
            return c
    return p


def _chunk_len(ntotal: int, nlist: int) -> int:
    """Chunk length Lc: ~the mean list size, clamped to [32, 256] pow2."""
    mean = max(1, ntotal // max(nlist, 1))
    return min(256, max(32, _next_pow2(mean)))


def build_chunked_image(
    q_vectors,
    scales,
    list_offsets: np.ndarray,
    lc: int,
    lo: int = 0,
    hi: int | None = None,
    pad_chunks: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Chunked CSR image of lists [lo, hi) as tensors on `device`:
      rows   (nc, Lc, d) int8 — list rows packed into fixed-size chunks
      scales (nc, Lc) f32     — 0 ⇒ padding row
      pos    (nc, Lc) int32   — global CSR position, −1 ⇒ padding
      clist  (nc,) int32      — owning list (local index li − lo), −1 ⇒ padding chunk
    where nc = Σ ceil(size/Lc) over [lo, hi), padded up to `pad_chunks` when
    given.  The arrays are zeroed on the device and blocks of CSR rows are
    scattered to their image rows, so the host never holds a chunked copy of
    the corpus."""
    device = resolve_device(device)
    offs = np.asarray(list_offsets, np.int64)
    hi = offs.shape[0] - 1 if hi is None else hi
    d = q_vectors.shape[1]
    sizes = np.diff(offs[lo : hi + 1])
    chunk_counts = -(-sizes // lc)
    castarts = np.zeros(hi - lo, np.int64)
    if hi - lo > 1:
        np.cumsum(chunk_counts[:-1], out=castarts[1:])
    nc = int(chunk_counts.sum())
    nc_pad = max(nc, 1) if pad_chunks is None else pad_chunks
    if nc_pad < nc:
        raise ValueError(f"pad_chunks={nc_pad} < the {nc} chunks of lists [{lo}, {hi})")
    nrows = nc_pad * lc
    rows = torch.zeros((nrows, d), dtype=torch.int8, device=device)
    sc = torch.zeros((nrows,), dtype=torch.float32, device=device)
    pos = torch.full((nrows,), -1, dtype=torch.int32, device=device)
    # image row of CSR row r (list li) = castart[li]·Lc + (r − csr_start[li])
    dst = np.repeat(castarts * lc - offs[lo:hi], sizes) + np.arange(offs[lo], offs[hi], dtype=np.int64)
    for a in range(0, dst.shape[0], _UPLOAD_ROWS):
        b = min(a + _UPLOAD_ROWS, dst.shape[0])
        src = slice(int(offs[lo]) + a, int(offs[lo]) + b)
        idx = torch.from_numpy(dst[a:b]).to(device)
        rows.index_copy_(0, idx, to_device(q_vectors[src], device))
        sc.index_copy_(0, idx, to_device(np.asarray(scales[src], np.float32), device))
        pos.index_copy_(0, idx, torch.arange(src.start, src.stop, dtype=torch.int32, device=device))
    clist = np.full((nc_pad,), -1, np.int32)
    clist[:nc] = np.repeat(np.arange(hi - lo, dtype=np.int32), chunk_counts)
    return {"rows": rows.reshape(nc_pad, lc, d), "scales": sc.reshape(nc_pad, lc), "pos": pos.reshape(nc_pad, lc),
            "clist": torch.from_numpy(clist).to(device)}


def chunk_budget(chunk_counts: np.ndarray, n_lists: int) -> int:
    """Worst-case probed-union chunk count: the n_lists largest lists'
    chunk counts."""
    nc = int(chunk_counts.sum())
    if n_lists >= chunk_counts.size:
        return nc
    desc = np.sort(chunk_counts)[::-1]
    return min(nc, int(desc[:n_lists].sum()))


def _readback(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy tensors to the host in one device→host transfer."""
    if all(t.device.type == "cpu" for t in tensors):
        return [t.numpy() for t in tensors]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(flat[off : off + nbytes].copy().view(dtype).reshape(t.shape))
        off += nbytes
    return out


def select_probes(coarse_scores: torch.Tensor, p: int) -> torch.Tensor:
    """The probe rule of both IVF tiers, on every route: each query's top-p
    lists by its q·c coarse scores (B, nlist), as in the JAX package.
    Returns the (B, p) probed lists."""
    return torch.topk(coarse_scores, min(p, coarse_scores.shape[1]), dim=1).indices


def _scan_topk(q: torch.Tensor, dv: dict, chunk_sel: torch.Tensor, k: int):
    """Scan the selected chunks through K3 and take the exact top-k:
    (vals (B, k') f32, CSR positions (B, k') int32, −1 where vals is −inf)."""
    qq, q_scale = quantize_rows_device(q)
    scores = int8_gather_scan(qq, q_scale, dv["rows"], dv["scales"], dv["pos"], chunk_sel)
    sub_pos = dv["pos"].index_select(0, chunk_sel.long()).reshape(-1)
    vals, ppos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return vals, torch.where(torch.isfinite(vals), sub_pos[ppos], -1)


def _search_device(q: torch.Tensor, dv: dict, k: int, probe_lists: int, u_cap: int):
    """Single-dispatch search over the u_cap best chunks: probed lists
    first (their chunks score ≥ 2), then the best-scoring other lists.
    Returns (vals, positions, n_union), n_union the real probed-union chunk
    count."""
    coarse = dv["coarse"]
    nlist = coarse.shape[0]
    clist = dv["clist"]
    coarse_scores = torch.matmul(q, coarse.T)
    per_q = select_probes(coarse_scores, probe_lists)
    presence = torch.zeros(nlist, device=q.device).index_fill_(0, per_q.reshape(-1), 1.0)
    agg = coarse_scores.amax(dim=0)
    agg = (agg - agg.min()) / (agg.max() - agg.min() + 1e-9)  # (0,1) tie-break
    list_score = presence * 2.0 + agg
    # all chunks of a probed list tie, so the chunk top-k takes whole lists
    chunk_score = torch.where(clist >= 0, list_score[clist.clamp(0, nlist - 1)], float("-inf"))
    n_union = (chunk_score >= 2.0).sum()
    u = min(clist.shape[0], u_cap)
    top_u = torch.sort(chunk_score, descending=True, stable=True).indices[:u]
    vals, ids = _scan_topk(q, dv, top_u.int(), k)
    return vals, ids, n_union


class IVFInt8Index:
    index_type = "ivf_int8"

    def __init__(
        self,
        d: int,
        coarse_centroids: np.ndarray,
        list_offsets: np.ndarray,
        list_ids: np.ndarray,  # (N,) int64, grouped by list
        q_vectors: np.ndarray,  # (N, d) int8, grouped by list
        scales: np.ndarray,  # (N,) f32
        nprobe: int = 64,
        exact_topk: bool = False,
        refine_vectors: np.ndarray | None = None,
        rerank_factor: int = 4,
        union: str | None = None,
        device: str | torch.device = "cuda",
    ):
        self.d = d
        self.coarse_centroids = np.asarray(coarse_centroids, np.float32)
        self.list_offsets = np.asarray(list_offsets, np.int64)
        self.list_ids = list_ids
        self.q_vectors = q_vectors
        self.scales = scales
        self.nprobe = nprobe  # = probe_lists (batch-shared)
        self.exact_topk = exact_topk  # kept for compatibility: top-k is always exact here
        # optional exact re-ranking over original fp16 rows (id order)
        self.refine_vectors = refine_vectors
        self.rerank_factor = rerank_factor
        # union sizing: exact | static | device | auto (see module docstring)
        self.union = union or os.environ.get("CRT_IVF_INT8_UNION", "auto")
        if self.union not in ("exact", "static", "auto", "device"):
            raise ValueError(f"union must be exact|static|auto|device, got {self.union!r}")
        self.device = resolve_device(device)
        self.last_union_chunks = 0  # probed-union chunks of the last batch, before padding
        self.overflow_redispatches = 0  # device-mode batches re-run after their union overflowed the cap
        # union="device" adaptive caps, keyed by (padded_b, nprobe)
        self._dev_caps: dict = {}
        self._device = None
        self._device_lock = threading.Lock()
        self._chunk_counts = None
        self._castarts = None
        self._pad_chunk = None  # index of the dedicated all-padding chunk
        self._id_to_pos = None

    @property
    def nlist(self) -> int:
        return self.coarse_centroids.shape[0]

    @property
    def ntotal(self) -> int:
        return int(self.list_ids.shape[0])

    def list_sizes(self) -> np.ndarray:
        return np.diff(self.list_offsets)

    # -- build -------------------------------------------------------------

    @classmethod
    def from_vectors(
        cls,
        x: np.ndarray,
        nlist: int,
        nprobe: int = 64,
        kmeans_niter: int = 20,
        seed: int = 0,
        refine: bool = False,
        refine_source=None,
        coarse: np.ndarray | None = None,
        id_offset: int = 0,
        union: str | None = None,
        device: str | torch.device = "cuda",
    ) -> "IVFInt8Index":
        """Build from raw vectors: k-means (skipped when `coarse` is given:
        the shard-build mode, every shard encoding against one trained
        quantizer), assignment, rows grouped by list and quantized chunkwise.
        `id_offset` shifts this shard's vector ids; `refine_source` (e.g. a
        ShardRowGather over the original fp16 shards) is the re-rank store
        as-is."""
        from ..ops import kmeans as km

        device = resolve_device(device)
        # disk-backed inputs stay disk-backed: np.asarray would strip the
        # memmap subclass and copy a non-f32 memmap into RAM
        is_disk = isinstance(x, np.memmap)
        if not is_disk:
            x = np.asarray(x, np.float32)
        n, d = x.shape
        if coarse is None:
            coarse_t = km.kmeans(x, nlist, niter=kmeans_niter, seed=seed, device=device)
        elif coarse.shape != (nlist, d):
            raise ValueError(f"pretrained coarse centroids {coarse.shape} do not match (nlist={nlist}, d={d})")
        else:
            coarse_t = torch.from_numpy(np.asarray(coarse, np.float32)).to(device)
        assign = km.assign_chunked(x, coarse_t)
        order = np.argsort(assign, kind="stable")
        offsets = np.zeros((nlist + 1,), np.int64)
        np.cumsum(np.bincount(assign, minlength=nlist), out=offsets[1:])
        # group and quantize chunkwise: x[order] would materialize the whole
        # f32 corpus in RAM even when x is a memmap
        scratch = [os.path.dirname(x.filename)] if is_disk and x.filename else []
        if is_disk:
            from .build import scratch_memmap

            q = scratch_memmap((n, d), np.int8, scratch)
        else:
            q = np.empty((n, d), np.int8)
        s = np.empty((n,), np.float32)
        chunk = 1 << 17
        for i in range(0, n, chunk):
            sel = order[i : i + chunk]
            q[i : i + len(sel)], s[i : i + len(sel)] = quantize_rows(np.asarray(x[sel], np.float32))
        refine_vectors = None
        if refine:
            if id_offset and refine_source is None:
                # refine rows are looked up by GLOBAL vector id
                raise ValueError("refine=True with id_offset needs refine_source indexed by GLOBAL id")
            if refine_source is not None:
                refine_vectors = refine_source
            elif is_disk:
                from .build import scratch_memmap

                refine_vectors = scratch_memmap((n, d), np.float16, scratch)
                for i in range(0, n, chunk):
                    refine_vectors[i : i + chunk] = np.asarray(x[i : i + chunk], np.float16)
            else:
                refine_vectors = x.astype(np.float16)
        ids = order.astype(np.int64) + id_offset
        return cls(d, coarse_t.cpu().numpy(), offsets, ids, q, s, nprobe=nprobe, refine_vectors=refine_vectors,
                   union=union, device=device)

    # -- device image -------------------------------------------------------

    def _ensure_device(self):
        # locked check-then-build: searches on several batcher threads must
        # not each build a corpus-sized device image
        with self._device_lock:
            if self._device is not None:
                return
            if self.ntotal >= np.iinfo(np.int32).max:
                raise ValueError(
                    f"ivf_int8 device image supports < 2^31 rows per index (got {self.ntotal}); shard the corpus"
                )
            lc = _chunk_len(self.ntotal, self.nlist)
            # the image carries int32 CSR positions, not vector ids: ids are
            # int64 on disk; positions map back through list_ids on the host
            self._chunk_counts = -(-self.list_sizes() // lc)
            nc = int(self._chunk_counts.sum())
            self._castarts = np.zeros_like(self._chunk_counts)
            np.cumsum(self._chunk_counts[:-1], out=self._castarts[1:])
            # one extra guaranteed-padding chunk at index nc: the exact-union
            # path pads its ¼-pow2 selection buckets with it — reusing a real
            # chunk would surface its rows as duplicate candidates
            self._pad_chunk = nc
            img = build_chunked_image(self.q_vectors, self.scales, self.list_offsets, lc, pad_chunks=nc + 1,
                                      device=self.device)
            img["coarse"] = torch.from_numpy(self.coarse_centroids).to(self.device)
            self._device = img

    def _positions_to_ids(self, pos: np.ndarray) -> np.ndarray:
        """int32 CSR positions → int64 vector ids (-1 passes through)."""
        pos = np.asarray(pos, np.int64)
        ids = np.asarray(self.list_ids)[np.clip(pos, 0, None)]
        return np.where(pos >= 0, ids, -1)

    @staticmethod
    def _pad_queries_pow2(queries) -> tuple[np.ndarray, int]:
        """Pad the batch dim to a power-of-two bucket by REPEATING the first
        query: repeats keep the probed-list union identical (they add no new
        lists).  Returns (padded queries, original B)."""
        q = np.asarray(queries, np.float32)
        b = q.shape[0]
        bucket = _next_pow2(b)
        if bucket > b:
            q = np.concatenate([q, np.repeat(q[:1], bucket - b, axis=0)])
        return q, b

    # -- search ------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.refine_vectors is not None and self.rerank_factor > 1:
            from .rerank import exact_rerank

            _, ids = self._search_int8(queries, k * self.rerank_factor)
            return exact_rerank(self.refine_vectors, queries, ids, k)
        return self._search_int8(queries, k)

    def resolve_union(self, padded_b: int) -> str:
        """The union route of a batch of padded size `padded_b`.  For
        union="auto": exact at every size.  The route sweep
        (`tools/sweep_routes.py`, 10M x 768, nlist 16,384, nprobe 64, on an
        H100 80GB HBM3 at 700 W) found exact the fastest at each B of 1-64
        in two runs but once (B=2, by 0.07 ms, reversed by 0.79 ms in the
        other run), the single query included, where static's one dispatch
        had won on the TPU: the read-back of the probed lists costs less
        than scanning the static worst-case budget."""
        if self.union != "auto":
            return self.union
        return "exact"

    def _device_union_cap(self, padded_b: int, p: int) -> int:
        """Adaptive chunk cap for union="device": seeded at the ¼-pow2 of the
        expected probed-union size, grown monotonically on observed
        overflows, never above the static worst case."""
        key = (padded_b, p)
        cap = self._dev_caps.get(key)
        if cap is None:
            cap = min(
                _quarter_pow2(max(16, int(self._union_expect_chunks(padded_b, p)))),
                _next_pow2(self._union_worst_chunks(padded_b, p)),
            )
            self._dev_caps[key] = cap
        return cap

    def _grow_device_cap(self, padded_b: int, p: int, n_union: int) -> int:
        worst = self._union_worst_chunks(padded_b, p)
        cap = min(_quarter_pow2(max(16, n_union)), _next_pow2(worst))
        cap = max(cap, self._dev_caps.get((padded_b, p), 0))
        self._dev_caps[(padded_b, p)] = cap
        return cap

    def _union_expect_chunks(self, padded_b: int, p: int) -> float:
        """E[probed-union chunks] with a 25 % skew margin."""
        nl = self.nlist
        exp_lists = nl * (1.0 - (1.0 - 1.0 / nl) ** (padded_b * p))
        return exp_lists * float(self._chunk_counts.mean()) * 1.25

    def _union_worst_chunks(self, padded_b: int, p: int) -> int:
        return chunk_budget(self._chunk_counts, padded_b * p)

    def _union_chunk_sel(self, per_q: np.ndarray) -> np.ndarray:
        """Chunk indices of the actual probed union (each probed list expands
        to its contiguous chunk range), padded to a ¼-pow2 bucket with the
        all-padding chunk; arange(all chunks) when the bucket would reach the
        whole image."""
        lists = np.unique(per_q.reshape(-1))
        cc = self._chunk_counts[lists]
        n = int(cc.sum())
        self.last_union_chunks = n
        cap = _quarter_pow2(max(n, 16))
        if cap >= self._pad_chunk:  # pad_chunk == real chunk count
            return np.arange(self._pad_chunk, dtype=np.int32)
        sel = np.full((cap,), self._pad_chunk, np.int32)
        ends = np.cumsum(cc)
        intra = np.arange(n, dtype=np.int64) - np.repeat(ends - cc, cc)
        sel[:n] = (np.repeat(self._castarts[lists], cc) + intra).astype(np.int32)
        return sel

    def _search_int8(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._search_int8_finish(self._search_int8_dispatch(queries, k))

    def _search_int8_dispatch(self, queries: np.ndarray, k: int) -> dict:
        """Phase 1 (non-blocking): enqueue the device work of this batch.
        Exact mode enqueues the coarse probe; static and device modes the
        whole search.  The handle carries the resolved route ("mode")."""
        b_in = np.asarray(queries).shape[0]
        if self.ntotal == 0:
            return {"mode": "empty", "b": b_in, "k": k}
        self._ensure_device()
        dv = self._device
        p = min(self.nprobe, self.nlist)
        q, b = self._pad_queries_pow2(queries)
        qd = torch.from_numpy(q).to(self.device)
        k_dev = min(k, self.ntotal)
        mode = self.resolve_union(q.shape[0])
        if mode == "exact":
            per_q = select_probes(torch.matmul(qd, dv["coarse"].T), p)
            return {"mode": mode, "q": qd, "per_q": per_q, "b": b, "k": k, "k_dev": k_dev}
        if mode == "device":
            u_cap = self._device_union_cap(q.shape[0], p)
        else:  # static: a budget covering the worst possible union of this padded batch
            u_cap = _next_pow2(chunk_budget(self._chunk_counts, q.shape[0] * p))
        vals, ids, n_union = _search_device(qd, dv, k_dev, p, u_cap)
        return {"mode": mode, "vals": vals, "ids": ids, "n_union": n_union, "u_cap": u_cap, "q": qd, "p": p,
                "b": b, "k": k, "k_dev": k_dev}

    def _search_int8_finish(self, h: dict) -> Tuple[np.ndarray, np.ndarray]:
        """Phase 2 (blocking): read the batch back.  Exact mode reads the
        probed lists, assembles the union selection and scans it first."""
        if h["mode"] == "empty":
            return np.full((h["b"], h["k"]), -np.inf, np.float32), np.full((h["b"], h["k"]), -1, np.int64)
        dv = self._device
        if h["mode"] == "exact":
            chunk_sel = self._union_chunk_sel(h["per_q"].cpu().numpy())
            sel = torch.from_numpy(chunk_sel).to(self.device)
            vals, ids = _readback(*_scan_topk(h["q"], dv, sel, h["k_dev"]))
        else:
            vals, ids, n_union = _readback(h["vals"], h["ids"], h["n_union"])
            n_union = int(n_union)
            self.last_union_chunks = n_union
            if h["mode"] == "device" and n_union > h["u_cap"]:
                # the union overflowed the adaptive cap, so probed lists
                # were cut from the scan: grow the cap (kept for later
                # batches of this shape) and run the batch again
                self.overflow_redispatches += 1
                u_cap = self._grow_device_cap(h["q"].shape[0], h["p"], n_union)
                vals, ids, _ = _readback(*_search_device(h["q"], dv, h["k_dev"], h["p"], u_cap))
        b, k = h["b"], h["k"]
        vals = vals[:b]
        ids = self._positions_to_ids(ids[:b])
        k_eff = vals.shape[1]
        if k_eff < k:
            vals = np.pad(vals, ((0, 0), (0, k - k_eff)), constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return vals, ids

    def _id_positions(self, ids: np.ndarray) -> np.ndarray:
        """id → CSR position; cached sort, KeyError on unknown ids."""
        if self._id_to_pos is None:
            all_ids = np.asarray(self.list_ids)
            order = np.argsort(all_ids, kind="stable")
            self._id_to_pos = (all_ids[order], order)
        sorted_ids, order = self._id_to_pos
        if order.size == 0:
            raise KeyError("reconstruct on an empty index")
        pos = np.clip(np.searchsorted(sorted_ids, ids), 0, len(order) - 1)
        missing = sorted_ids[pos] != ids
        if missing.any():
            raise KeyError(f"ids not in index: {np.asarray(ids)[missing][:8].tolist()}")
        return order[pos]

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        pos = self._id_positions(ids)
        return np.asarray(self.q_vectors[pos], np.float32) * np.asarray(self.scales[pos])[:, None]

    def search_and_reconstruct(self, queries: np.ndarray, k: int):
        vals, ids = self.search(queries, k)
        if self.ntotal == 0:  # all-(-1) ids: zeros, like FlatIndex
            return vals, ids, np.zeros((*ids.shape, self.d), np.float32)
        flat = ids.reshape(-1)
        # fill invalid (-1) slots with a real id so _id_positions can't raise
        fill = int(np.asarray(self.list_ids[:1])[0])
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
                    "type": "ivf_int8",
                    "d": self.d,
                    "ntotal": self.ntotal,
                    "metric": "ip",
                    "nlist": self.nlist,
                    "nprobe": self.nprobe,
                    "has_refine": self.refine_vectors is not None,
                    "rerank_factor": self.rerank_factor,
                },
                f,
            )
        np.save(os.path.join(path, "coarse_centroids.npy"), self.coarse_centroids)
        np.save(os.path.join(path, "list_offsets.npy"), self.list_offsets)
        np.save(os.path.join(path, "list_ids.npy"), np.asarray(self.list_ids))
        np.save(os.path.join(path, "q_vectors.npy"), np.asarray(self.q_vectors))
        np.save(os.path.join(path, "scales.npy"), np.asarray(self.scales))
        if self.refine_vectors is not None:
            from .rerank import save_rows_fp16

            save_rows_fp16(os.path.join(path, "refine_vectors.npy"), self.refine_vectors)

    @classmethod
    def load(cls, path: str, mmap: bool = True, device: str | torch.device = "cuda") -> "IVFInt8Index":
        with open(os.path.join(path, "header.json")) as f:
            h = json.load(f)
        mm = "r" if mmap else None
        refine = None
        if h.get("has_refine"):
            refine = np.load(os.path.join(path, "refine_vectors.npy"), mmap_mode=mm)
        return cls(
            h["d"],
            np.load(os.path.join(path, "coarse_centroids.npy")),
            np.load(os.path.join(path, "list_offsets.npy")),
            np.load(os.path.join(path, "list_ids.npy"), mmap_mode=mm),
            np.load(os.path.join(path, "q_vectors.npy"), mmap_mode=mm),
            np.load(os.path.join(path, "scales.npy")),
            nprobe=h.get("nprobe", 64),
            refine_vectors=refine,
            rerank_factor=h.get("rerank_factor", 4),
            device=device,
        )

"""clip_index: build indices over the `inference` output folders.

Counterpart of `clip_retrieval_tpu/index/build.py`, with the same artifacts,
so that an index folder built by either package loads and serves in the
other: `image.index/` and `text.index/` (the index directories with their
`header.json`, the calibration stamped into it), `image.json`/`text.json`
infos with the same keys, and a copy of `metadata/`.

Build path, every product on `device` ("cuda" by default; raises without a
GPU; tests pass "cpu"):
  1. parameters from the byte budget or an explicit key (`autotune.py`);
  2. train: OPQ rotation (alternating PQ/Procrustes) → coarse k-means → PQ
     codebooks on the residuals (`ops/kmeans.py`, `ops/pq.py`);
  3. encode: stream the shards through the device (assign + residual PQ);
  4. group codes and ids by list (CSR), calibrate nprobe against an exact
     brute force, save, score recall.
The JAX package's local-mesh branch (coarse k-means sharded over several
chips) is not ported: one explicit device.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import time

import numpy as np
import torch

from ..ops import kmeans as kmeans_ops
from ..ops import pq as pq_ops
from ..utils.device import resolve_device
from .autotune import IndexParams, select_params
from .flat import FlatIndex
from .ivfpq import IVFPQIndex
from .rerank import ShardRowGather

LOGGER = logging.getLogger("clip_index")


class EmbeddingShards:
    """Lazy view over a folder of npy embedding shards (mmap'd)."""

    def __init__(self, folder: str):
        self.paths = sorted(glob.glob(os.path.join(folder, "*.npy")))
        if not self.paths:
            raise ValueError(f"no npy shards found in {folder}")
        self.arrays = [np.load(p, mmap_mode="r") for p in self.paths]
        self.counts = [a.shape[0] for a in self.arrays]
        self.d = self.arrays[0].shape[1]
        self.total = int(sum(self.counts))

    def sample(self, k: int, seed: int = 0) -> np.ndarray:
        """Uniform random sample of ≤k rows across shards, in row order."""
        rng = np.random.default_rng(seed)
        k = min(k, self.total)
        idx = np.sort(rng.choice(self.total, size=k, replace=False))
        out = np.empty((k, self.d), np.float32)
        offs = np.cumsum([0] + self.counts)
        for arr, start, end in zip(self.arrays, offs[:-1], offs[1:]):
            sel = idx[(idx >= start) & (idx < end)] - start
            if sel.size:
                out[np.searchsorted(idx, sel + start)] = np.asarray(arr[sel], np.float32)
        return out

    def iter_chunks(self, chunk: int = 1 << 17):
        """Yields (global_start, np.float32 chunk)."""
        offset = 0
        for arr in self.arrays:
            for i in range(0, arr.shape[0], chunk):
                yield offset + i, np.asarray(arr[i : i + chunk], np.float32)
            offset += arr.shape[0]


def scratch_memmap(shape, dtype, scratch_dirs=()) -> np.ndarray:
    """Unlinked disk-backed array for corpus-scale transients.  Tries each
    candidate dir, skipping unwritable ones, then the system tmp dir; the
    file is unlinked at once (the mapping keeps it alive), so it can neither
    leak nor be picked up by shard globs."""
    import tempfile

    last: OSError | None = None
    for d in [*scratch_dirs, None]:
        tmp_name = None
        try:
            tmp = tempfile.NamedTemporaryFile(suffix=".scratch", dir=d, delete=False)
            tmp.close()
            tmp_name = tmp.name
            arr = np.lib.format.open_memmap(tmp_name, mode="w+", dtype=dtype, shape=shape)
            os.unlink(tmp_name)
            return arr
        except OSError as e:  # unwritable/full candidate → next
            last = e
            try:  # a failing unlink must not abort the fallback chain itself
                if tmp_name is not None and os.path.exists(tmp_name):
                    os.unlink(tmp_name)
            except OSError:
                pass
    raise last  # pragma: no cover — system tmp unwritable


def build_index_from_shards(
    shards: EmbeddingShards,
    params: IndexParams,
    nprobe: int = 16,
    train_points: int = 1 << 20,
    seed: int = 0,
    refine: bool | None = None,
    timings: dict | None = None,
    scratch_dir: str | None = None,
    device: str | torch.device = "cuda",
):
    """Train + encode an index over all shard rows (ids = global row order).

    refine=None follows the autotune decision (params.use_refine); True/False
    force the exact re-rank store on/off.  A `timings` dict, if given,
    receives per-phase wall seconds (train_s / encode_s)."""
    device = resolve_device(device)
    if refine is None:
        refine = getattr(params, "use_refine", False)
    n, d = shards.total, shards.d
    if params.kind == "flat":
        index = FlatIndex(d, device=device)
        for _, block in shards.iter_chunks():
            index.add(block)
        return index

    scratch = [scratch_dir] if scratch_dir else []
    scratch.append(os.path.dirname(shards.paths[0]))

    if params.kind == "ivf_int8":
        from .ivf_int8 import IVFInt8Index

        x = scratch_memmap((n, d), np.float32, scratch)  # disk-backed: n·d·4 bytes
        for start, block in shards.iter_chunks():
            x[start : start + block.shape[0]] = block
        return IVFInt8Index.from_vectors(
            x, nlist=params.nlist, nprobe=nprobe, seed=seed, refine=refine,
            refine_source=ShardRowGather(shards) if refine else None, device=device,
        )

    if params.kind == "flat_int8":
        from ..ops.int8mm import quantize_rows
        from .sharded_flat import ShardedFlatIndex

        q = scratch_memmap((n, d), np.int8, scratch)
        s = np.empty((n,), np.float32)
        for start, block in shards.iter_chunks():
            q[start : start + block.shape[0]], s[start : start + block.shape[0]] = quantize_rows(block)
        return ShardedFlatIndex(d, q, s, device=device)

    t0 = time.time()
    sample = shards.sample(min(train_points, n), seed)
    LOGGER.info("training on %d samples (d=%d)", sample.shape[0], d)
    rotation = None
    sample_r = sample
    if params.use_opq:
        pq_rot = pq_ops.train_opq(sample, params.m, params.ksub, opq_iters=4, pq_niter=8, seed=seed, device=device)
        rotation = pq_rot.rotation.cpu().numpy()
        sample_r = sample @ rotation
    coarse = kmeans_ops.kmeans(sample_r, params.nlist, niter=20, seed=seed, device=device)
    coarse_np = coarse.cpu().numpy()
    # PQ on the residuals of the training sample
    assign = kmeans_ops.assign_chunked(sample_r, coarse)
    pq = pq_ops.train_pq(sample_r - coarse_np[assign], params.m, params.ksub, niter=15, seed=seed, device=device)
    LOGGER.info("train done in %.1fs", time.time() - t0)
    if timings is not None:
        timings["train_s"] = round(time.time() - t0, 1)

    # encode all vectors, streaming
    t0 = time.time()
    all_assign = np.empty((n,), np.int32)
    all_codes = np.empty((n, params.m), np.uint8)
    for start, block in shards.iter_chunks():
        br = block @ rotation if rotation is not None else block
        a = kmeans_ops.assign_chunked(br, coarse)
        all_assign[start : start + block.shape[0]] = a
        all_codes[start : start + block.shape[0]] = pq_ops.pq_encode(br - coarse_np[a], pq)
    LOGGER.info("encode done in %.1fs", time.time() - t0)
    if timings is not None:
        timings["encode_s"] = round(time.time() - t0, 1)

    # group by list (CSR)
    order = np.argsort(all_assign, kind="stable")
    offsets = np.zeros((params.nlist + 1,), np.int64)
    np.cumsum(np.bincount(all_assign, minlength=params.nlist), out=offsets[1:])
    return IVFPQIndex(
        d=d,
        coarse_centroids=coarse_np,
        codebooks=pq.codebooks.cpu().numpy(),
        rotation=rotation,
        list_offsets=offsets,
        list_ids=order.astype(np.int64),
        list_codes=all_codes[order],
        nprobe=nprobe,
        # exact re-rank store: the source shards already hold the fp16 rows
        # in id order; save() persists a real copy
        refine_vectors=ShardRowGather(shards) if refine else None,
        device=device,
    )


def _exact_ground_truth(shards: EmbeddingShards, queries: np.ndarray, k: int, device) -> np.ndarray:
    """Top-k ids by exact brute force over the full corpus (fp16 rows)."""
    exact = FlatIndex(shards.d, device=device)
    for _, block in shards.iter_chunks():
        exact.add(block.astype(np.float16))
    _, gt = exact.search(queries, k)
    return gt


def _recall_vs_gt(gt: np.ndarray, got: np.ndarray) -> float:
    return float(np.mean([
        len(set(gt[i][gt[i] >= 0]) & set(got[i][got[i] >= 0])) / max(1, (gt[i] >= 0).sum())
        for i in range(gt.shape[0])
    ]))


def score_index(index, shards: EmbeddingShards, n_queries: int = 100, k: int = 40, seed: int = 7, queries=None,
                gt=None, device: str | torch.device = "cuda") -> dict:
    """Recall@k vs exact brute force on a query sample.  Pass precomputed
    (queries, gt) to share one brute-force pass with calibrate_nprobe."""
    if queries is None:
        queries = shards.sample(n_queries, seed=seed)
    if gt is None:
        gt = _exact_ground_truth(shards, queries, k, resolve_device(device))
    _, got = index.search(queries, k)
    return {f"recall@{k}": _recall_vs_gt(gt[:, :k], got), "n_queries": len(queries)}


def calibrate_nprobe(
    index,
    shards: EmbeddingShards,
    target_recall: float = 0.95,
    k: int = 10,
    n_queries: int = 100,
    seed: int = 7,
    max_nprobe: int = 256,
    queries=None,
    gt=None,
    device: str | torch.device = "cuda",
) -> dict | None:
    """Pick the smallest nprobe whose recall@k vs exact brute force reaches
    the target (autofaiss's search-parameter tuning).  Sets `index.nprobe`
    (persisted by `index.save`) and returns {"nprobe", "target_recall",
    "recall_k", "recall_curve", "recall_achieved", "target_missed"}, or None
    for exact tiers.  When the nprobe sweep plateaus below the target on a
    refine-tier index, the loss is the ADC→rerank cutoff, not missed cells,
    so a second sweep doubles `index.rerank_factor` (also persisted)."""
    if getattr(index, "nprobe", None) is None:
        return None  # exact tiers carry nprobe=None for API parity only
    nlist = getattr(index, "nlist", max_nprobe)
    if queries is None:
        queries = shards.sample(n_queries, seed=seed)
    if gt is None:
        gt = _exact_ground_truth(shards, queries, k, resolve_device(device))
    gt = gt[:, :k]

    def recall_b1():
        # single-query searches: the int8 IVF tier union-probes a batch, so a
        # batched pass would overstate serving recall
        got = np.concatenate([index.search(queries[i : i + 1], k)[1] for i in range(len(queries))])
        return _recall_vs_gt(gt, got)

    curve: dict[str, float] = {}
    chosen = None
    candidates = []
    cand = 1
    while cand < min(max_nprobe, nlist):
        candidates.append(cand)
        cand *= 2
    candidates.append(min(max_nprobe, nlist))
    for cand in candidates:
        index.nprobe = cand
        r = recall_b1()
        curve[str(cand)] = round(r, 4)
        if r >= target_recall:
            chosen = cand
            break
    target_missed = chosen is None
    rerank_curve: dict[str, float] = {}
    if target_missed:
        best = max(curve.values())
        # the cheapest point on the plateau, not the largest probed
        chosen = next(int(np_) for np_, r in curve.items() if r >= best - 0.002)
        index.nprobe = chosen
        if getattr(index, "refine_vectors", None) is not None and getattr(index, "rerank_factor", None) is not None:
            rf = index.rerank_factor
            while rf < 128 and target_missed:
                rf *= 2
                index.rerank_factor = rf
                r = recall_b1()
                rerank_curve[str(rf)] = round(r, 4)
                if r >= target_recall:
                    target_missed = False
    if target_missed:
        LOGGER.warning(
            "calibration missed target recall %.2f (best %.3f at nprobe=%d%s) — consider more nlist or the refine tier",
            target_recall, max([*curve.values(), *rerank_curve.values()]), chosen,
            f", rerank_factor={index.rerank_factor}" if rerank_curve else "",
        )
    index.nprobe = chosen
    out = {
        "nprobe": chosen,
        "target_recall": target_recall,
        "recall_k": k,
        "recall_curve": curve,
        "recall_achieved": max(rerank_curve.values()) if rerank_curve else curve[str(chosen)],
        "target_missed": target_missed,
    }
    if rerank_curve:
        out["rerank_factor"] = index.rerank_factor
        out["rerank_curve"] = rerank_curve
    return out


def quantize(
    embeddings_path: str,
    index_path: str,
    infos_path: str,
    max_index_memory_usage: str,
    index_key: str | None,
    nprobe: int | None,
    compute_recall: bool,
    refine: bool | None = None,
    target_recall: float = 0.95,
    max_nprobe: int = 256,
    device: str | torch.device = "cuda",
):
    """Build, calibrate, save and score one index.  nprobe=None → build with
    the default, then calibrate the smallest nprobe reaching recall@10 ≥
    target_recall; an explicit int pins it."""
    device = resolve_device(device)
    shards = EmbeddingShards(embeddings_path)
    params = select_params(shards.total, shards.d, max_index_memory_usage, index_key)
    LOGGER.info("building %s over %d×%d", params.index_key, shards.total, shards.d)
    if nprobe is not None and nprobe < 1:
        raise ValueError(f"nprobe must be >= 1, got {nprobe}")
    t0 = time.time()
    timings: dict = {}
    index = build_index_from_shards(
        shards, params, nprobe=16 if nprobe is None else nprobe, refine=refine, timings=timings,
        scratch_dir=os.path.dirname(os.path.abspath(index_path)), device=device,
    )
    infos = {"index_key": params.index_key, "ntotal": shards.total, "d": shards.d, **timings}
    # one brute-force ground truth (k=40 ⊇ calibration's k=10) shared by
    # calibration and recall scoring
    queries = gt = None
    if compute_recall:
        queries = shards.sample(100, seed=7)
        gt = _exact_ground_truth(shards, queries, 40, device)
    cal = None
    if nprobe is None and compute_recall:
        cal = calibrate_nprobe(index, shards, target_recall=target_recall, max_nprobe=max_nprobe, queries=queries,
                               gt=gt, device=device)
        if cal:
            infos["nprobe_calibration"] = cal
    elif nprobe is None and getattr(index, "nprobe", None) is not None:
        print(
            "WARNING: nprobe calibration skipped because compute_recall=False — the index keeps the default "
            f"nprobe={index.nprobe}; pass an explicit nprobe or enable compute_recall to tune it to the recall target"
        )
    infos["build_seconds"] = time.time() - t0
    index.save(index_path)  # after calibration: nprobe persists in the header
    if cal:
        # stamp the calibration outcome into the header, where serving reads it
        header_path = os.path.join(index_path, "header.json")
        if os.path.exists(header_path):
            with open(header_path) as f:
                header = json.load(f)
            header["calibration"] = cal
            with open(header_path, "w") as f:
                json.dump(header, f)
    if compute_recall:
        infos.update(score_index(index, shards, queries=queries, gt=gt))
    with open(infos_path, "w") as f:
        json.dump(infos, f)
    return index, infos


def clip_index(
    embeddings_folder: str,
    index_folder: str,
    max_index_memory_usage: str = "4G",
    current_memory_available: str = "16G",  # accepted for CLI parity
    copy_metadata: bool = True,
    image_subfolder: str = "img_emb",
    text_subfolder: str = "text_emb",
    index_key: str | None = None,
    nprobe: int | None = None,  # None = calibrate to recall@10 ≥ target_recall
    compute_recall: bool = True,
    refine: bool | None = None,  # None = autotune decides (use_refine)
    nb_cores: int | None = None,  # accepted for CLI parity
    target_recall: float = 0.95,
    max_nprobe: int = 256,
    device: str = "cuda",
):
    """Build image/text indices from an inference output folder."""
    device = resolve_device(device)
    if current_memory_available != "16G":
        print(
            "WARNING: current_memory_available is accepted for CLI parity with the reference (autofaiss) but "
            "ignored — the build sizes its own transients from max_index_memory_usage"
        )
    if nb_cores is not None:
        print("WARNING: nb_cores is accepted for CLI parity but ignored — host-side work uses OpenMP/thread defaults")
    os.makedirs(index_folder, exist_ok=True)
    for sub, name in ((image_subfolder, "image"), (text_subfolder, "text")):
        emb_path = os.path.join(embeddings_folder, sub)
        if os.path.exists(emb_path):
            quantize(
                emb_path, os.path.join(index_folder, f"{name}.index"), os.path.join(index_folder, f"{name}.json"),
                max_index_memory_usage, index_key, nprobe, compute_recall, refine, target_recall, max_nprobe,
                device=device,
            )
    metadata_src = os.path.join(embeddings_folder, "metadata")
    if copy_metadata and os.path.exists(metadata_src):
        shutil.copytree(metadata_src, os.path.join(index_folder, "metadata"), dirs_exist_ok=True)

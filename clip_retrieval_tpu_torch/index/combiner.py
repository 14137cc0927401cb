"""index_combiner: merge per-shard IVF indices sharing one trained prefix.

Counterpart of `clip_retrieval_tpu/index/combiner.py`, with the same
functions and the same output: the inverted lists are CSR arrays, so the
merge concatenates each list's segments from every shard in shard order on
the host (no device work), into disk-backed scratch arrays.  The merged
index lives on the shards' device and builds its device image lazily, at its
first search, as a loaded index does; its folder loads in either package.

Shards must share the coarse centroids (and, for IVF-PQ, the codebooks and
rotation): the shards of one trained index.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from ..utils.device import resolve_device
from .build import scratch_memmap
from .ivf_int8 import IVFInt8Index
from .ivfpq import IVFPQIndex
from .store import load_index

_ROWS = 1 << 17  # rows per streamed block of a refine store


def _merge_refine(indices, ids, total: int, d: int, scratch):
    """Merge the exact re-rank stores when every shard carries one and the
    ids partition 0..total-1 (refine rows are indexed by id); otherwise the
    merged index degrades to scan-only with a warning, never silently.
    Shared by the ivfpq and ivf_int8 combiners."""
    refine = None
    have_refine = [ix.refine_vectors is not None for ix in indices]
    if any(have_refine) and not all(have_refine):
        print(
            f"WARNING: only {sum(have_refine)}/{len(indices)} shards carry "
            "an exact re-rank store — dropping the refine tier from the "
            "combined index (recall falls back to the raw scan)"
        )
    if all(have_refine):
        # mergeable iff every shard's ids are a contiguous range (id = shard
        # offset + local build row) and the ranges tile 0..total-1
        shard_ranges = []
        ok = True
        for ix in indices:
            sids = np.sort(np.asarray(ix.list_ids))
            if sids.size and not np.array_equal(sids, np.arange(sids[0], sids[0] + sids.size)):
                ok = False
                break
            shard_ranges.append((int(sids[0]) if sids.size else 0, sids.size))
        if ok and ids.min() >= 0 and ids.max() == total - 1 and len(np.unique(ids)) == total:
            # disk-backed: the merged store is total·d·2 bytes and must not live in RAM
            refine = scratch_memmap((total, d), np.float16, scratch)
            for ix, (lo, n) in zip(indices, shard_ranges):
                # streamed: the source may be a memmap or a ShardRowGather
                for i in range(0, n, _ROWS):
                    hi = min(i + _ROWS, n)
                    refine[lo + i : lo + hi] = np.asarray(ix.refine_vectors[i:hi], np.float16)
        else:
            print(
                "WARNING: shard ids do not tile the merged range; "
                "dropping the refine tier from the combined index"
            )
    return refine


def _merge_lists(indices, arrays: list[str], widths: dict, scratch):
    """Concatenate each list's segment of every shard, in shard order, into
    scratch arrays: (offsets, {name: merged array}) for the CSR arrays named
    in `arrays` (`widths[name]` = (row shape, dtype))."""
    base = indices[0]
    nlist = base.nlist
    sizes = np.zeros((nlist,), np.int64)
    for ix in indices:
        sizes += ix.list_sizes()
    offsets = np.zeros((nlist + 1,), np.int64)
    np.cumsum(sizes, out=offsets[1:])
    total = int(offsets[-1])
    out = {name: scratch_memmap((total, *widths[name][0]), widths[name][1], scratch) for name in arrays}
    cursor = offsets[:-1].copy()
    for ix in indices:
        offs = ix.list_offsets
        for li in range(nlist):
            s, e = offs[li], offs[li + 1]
            n = int(e - s)
            if n:
                c = cursor[li]
                for name in arrays:
                    out[name][c : c + n] = getattr(ix, name)[s:e]
                cursor[li] += n
    return offsets, out


def combine_ivfpq(indices: list[IVFPQIndex], scratch_dir: str | None = None) -> IVFPQIndex:
    base = indices[0]
    for other in indices[1:]:
        if not np.allclose(base.coarse_centroids, other.coarse_centroids):
            raise ValueError("shard indices trained differently (centroids)")
        if not np.allclose(base.codebooks, other.codebooks):
            raise ValueError("shard indices trained differently (codebooks)")
    scratch = [scratch_dir] if scratch_dir else []
    offsets, merged = _merge_lists(indices, ["list_ids", "list_codes"],
                                   {"list_ids": ((), np.int64), "list_codes": ((base.m,), np.uint8)}, scratch)
    ids = merged["list_ids"]
    refine = _merge_refine(indices, ids, int(offsets[-1]), base.d, scratch)
    return IVFPQIndex(
        d=base.d,
        coarse_centroids=base.coarse_centroids,
        codebooks=base.codebooks,
        rotation=base.rotation,
        list_offsets=offsets,
        list_ids=ids,
        list_codes=merged["list_codes"],
        nprobe=base.nprobe,
        refine_vectors=refine,
        rerank_factor=base.rerank_factor,
        device=base.device,
    )


def combine_ivf_int8(indices: list[IVFInt8Index], scratch_dir: str | None = None) -> IVFInt8Index:
    """Merge IVF-int8 shard indices sharing coarse centroids (the same
    list concatenation as the PQ variant).  The merged corpus (int8 rows,
    ids and scales) is staged in disk-backed scratch, never RAM."""
    base = indices[0]
    for other in indices[1:]:
        if not np.allclose(base.coarse_centroids, other.coarse_centroids):
            raise ValueError("shard indices trained differently (centroids)")
    scratch = [scratch_dir] if scratch_dir else []
    offsets, merged = _merge_lists(
        indices, ["list_ids", "q_vectors", "scales"],
        {"list_ids": ((), np.int64), "q_vectors": ((base.d,), np.int8), "scales": ((), np.float32)}, scratch,
    )
    ids = merged["list_ids"]
    refine = _merge_refine(indices, ids, int(offsets[-1]), base.d, scratch)
    return IVFInt8Index(
        base.d, base.coarse_centroids, offsets, ids, merged["q_vectors"], merged["scales"],
        nprobe=base.nprobe, refine_vectors=refine, rerank_factor=base.rerank_factor, device=base.device,
    )


def index_combiner(indices_folder: str, output_folder: str, device: str | torch.device = "cuda"):
    """CLI entry: merge all index dirs under indices_folder into one
    (`output_folder/populated.index`), held on `device`."""
    device = resolve_device(device)
    paths = sorted(
        p
        for p in glob.glob(os.path.join(indices_folder, "*"))
        if os.path.isdir(p) and os.path.exists(os.path.join(p, "header.json"))
    )
    if not paths:
        raise ValueError(f"no index directories in {indices_folder}")
    with open(os.path.join(paths[0], "header.json")) as f:
        kind = json.load(f)["type"]
    indices = [load_index(p, device=device) for p in paths]
    os.makedirs(output_folder, exist_ok=True)
    if kind == "ivfpq":
        merged = combine_ivfpq(indices, scratch_dir=output_folder)
    elif kind == "ivf_int8":
        merged = combine_ivf_int8(indices, scratch_dir=output_folder)
    else:
        raise ValueError(f"combiner supports list-based indices (ivfpq, ivf_int8); got {kind!r}")
    merged.save(os.path.join(output_folder, "populated.index"))
    return merged

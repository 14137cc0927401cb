"""Index loading/dispatch on the index header's type.

Counterpart of `clip_retrieval_tpu/index/store.py`.  The port serves `flat`,
`flat_int8` (`ShardedFlatIndex` on one device), `ivf_int8` and `ivfpq`
directories on one device; the list-sharded multi-chip IVF tier raises and
names the ROADMAP item that ports it.
"""

from __future__ import annotations

import json
import logging
import os

import torch

from ..utils.device import resolve_device
from .flat import FlatIndex
from .ivf_int8 import IVFInt8Index
from .ivfpq import IVFPQIndex
from .sharded_flat import ShardedFlatIndex

LOGGER = logging.getLogger("clip_back")


def load_index(path: str, enable_mmap: bool = True, sharded: bool | None = None,
               device: str | torch.device = "cuda"):
    """Load an index directory onto `device`; dispatches on header type.

    `sharded=True` (or CRT_SHARDED_IVF=1) asks for the list-sharded
    multi-chip IVF tier, which is not ported."""
    device = resolve_device(device)
    header_path = os.path.join(path, "header.json")
    if not os.path.exists(header_path):
        raise FileNotFoundError(f"no index header at {header_path}")
    with open(header_path) as f:
        header = json.load(f)
    kind = header["type"]
    cal = header.get("calibration")
    if cal and cal.get("target_missed"):
        # the build's nprobe calibration shipped below its recall contract
        # (the JAX build stamps the outcome into the header) — surface it
        # where the operator will see it: at serving/CLI load time
        LOGGER.warning(
            "index %s MISSED its recall target at build time: recall@%s = %.3f < %.2f at nprobe=%s (calibration "
            "capped at max_nprobe) — rebuild with more nlist, a higher max_nprobe, or the refine tier, or serve "
            "with an explicit larger nprobe",
            path,
            cal.get("recall_k"),
            cal.get("recall_achieved", float("nan")),
            cal.get("target_recall", float("nan")),
            cal.get("nprobe"),
        )
    if sharded is None:
        sharded = os.environ.get("CRT_SHARDED_IVF") == "1"
    if kind == "flat":
        return FlatIndex.load(path, mmap=enable_mmap, device=device)
    if kind == "flat_int8":
        return ShardedFlatIndex.load(path, mmap=enable_mmap, device=device)
    if kind == "ivf_int8":
        if sharded:
            raise NotImplementedError(
                f"{path}: the list-sharded multi-chip IVF tier (index/sharded_ivf.py) is not ported yet "
                "(ROADMAP queue 1, item 8); serve it unsharded"
            )
        return IVFInt8Index.load(path, mmap=enable_mmap, device=device)
    if kind == "ivfpq":
        return IVFPQIndex.load(path, mmap=enable_mmap, device=device)
    raise ValueError(f"unknown index type {kind!r}")

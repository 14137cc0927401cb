"""Index loading/dispatch on the index header's type.

Counterpart of `clip_retrieval_tpu/index/store.py`.  `flat`, `ivf_int8` and
`ivfpq` directories load onto one device; `flat_int8` (`ShardedFlatIndex`)
and, with `sharded`, `ivf_int8` (`ShardedIVFInt8Index`) shard over a list of
devices.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Sequence

import torch

from ..utils.device import resolve_device
from .flat import FlatIndex
from .ivf_int8 import IVFInt8Index
from .ivfpq import IVFPQIndex
from .sharded_flat import ShardedFlatIndex
from .sharded_ivf import ShardedIVFInt8Index

LOGGER = logging.getLogger("clip_back")


def load_index(path: str, enable_mmap: bool = True, sharded: bool | None = None,
               device: str | torch.device = "cuda", devices: Sequence | None = None):
    """Load an index directory; dispatches on header type.

    `sharded=True` (or CRT_SHARDED_IVF=1) executes an ivf_int8 index on the
    list-sharded tier (`sharded_ivf.py`) instead of one device; the on-disk
    format is identical.  flat_int8 is always sharded.  The sharded tiers
    lay their shards on `devices`; by default every visible CUDA device when
    `device` is "cuda", else `device` alone.  The other tiers load onto
    `device`."""
    device = resolve_device(device)
    if devices is None and device != torch.device("cuda"):
        devices = [device]
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
        return ShardedFlatIndex.load(path, mmap=enable_mmap, devices=devices)
    if kind == "ivf_int8":
        if sharded:
            return ShardedIVFInt8Index.load(path, mmap=enable_mmap, devices=devices)
        return IVFInt8Index.load(path, mmap=enable_mmap, device=device)
    if kind == "ivfpq":
        return IVFPQIndex.load(path, mmap=enable_mmap, device=device)
    raise ValueError(f"unknown index type {kind!r}")

"""Serving options: CLI defaults layered with per-index JSON overrides.

Copy of `clip_retrieval_tpu/back/options.py`, plus `device`: the one device
the model, the safety head and the index of a resource live on."""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class ClipOptions:
    indice_folder: str = ""
    clip_model: str = "ViT-B/32"
    checkpoint: Optional[str] = None
    enable_hdf5: bool = False
    enable_faiss_memory_mapping: bool = False  # name kept for CLI parity
    columns_to_return: List[str] = dataclasses.field(
        default_factory=lambda: ["url", "image_path", "caption", "NSFW"]
    )
    reorder_metadata_by_ivf_index: bool = False
    enable_mclip_option: bool = False
    mclip_model: str = ""
    use_jit: bool = True
    use_arrow: bool = False
    provide_safety_model: bool = False
    provide_violence_detector: bool = False
    provide_aesthetic_embeddings: bool = True
    nprobe: Optional[int] = None  # override the index's stored nprobe
    rerank_factor: Optional[int] = None  # IVF-PQ refine over-fetch factor
    # execute ivf_int8 indices on the list-sharded multi-chip tier (not
    # ported; ROADMAP queue 1, item 8); None → CRT_SHARDED_IVF env decides
    sharded_index: Optional[bool] = None
    device: str = "cuda"

    def with_overrides(self, d: dict) -> "ClipOptions":
        known = {f.name for f in dataclasses.fields(self)}
        return dataclasses.replace(
            self, **{k: v for k, v in d.items() if k in known}
        )


def dict_to_clip_options(d: dict, clip_options: ClipOptions) -> ClipOptions:
    return clip_options.with_overrides(d)

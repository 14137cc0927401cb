"""Per-index resource bundle + multi-index loading.

Counterpart of `clip_retrieval_tpu/back/resources.py`: `ClipResource`,
`load_clip_index`, `load_clip_indices`.  The model bundle, the M-CLIP text
encoder (when `enable_mclip_option` and `mclip_model` are set), the safety
head and the indices of a resource live on `clip_options.device`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, List

from ..index.store import load_index
from ..models import safety as safety_mod
from ..models import zoo
from ..utils.device import resolve_device
from .metadata import load_metadata_provider
from .options import ClipOptions, dict_to_clip_options

LOGGER = logging.getLogger("clip_back")


@dataclasses.dataclass
class ClipResource:
    bundle: Any  # zoo.ModelBundle (model + tokenizer)
    model_txt_mclip: Any
    safety_model: Any
    violence_detector: Any
    aesthetic_embeddings: Any
    metadata_provider: Any
    image_index: Any
    text_index: Any
    ivf_old_to_new_mapping: Any
    columns_to_return: List[str]
    metadata_is_ordered_by_ivf: bool


def load_clip_index(clip_options: ClipOptions) -> ClipResource:
    device = resolve_device(clip_options.device)
    if not clip_options.use_jit:
        LOGGER.warning("use_jit=False is accepted for CLI parity but ignored — PyTorch runs eagerly")
    bundle = zoo.load_model(clip_options.clip_model, clip_options.checkpoint, device)

    model_txt_mclip = None
    if clip_options.enable_mclip_option and clip_options.mclip_model:
        from ..models.mclip import load_mclip

        try:
            model_txt_mclip = load_mclip(clip_options.mclip_model, device)
        except Exception as e:  # serving boots without the option, as the JAX package does
            LOGGER.warning("mCLIP unavailable (%s); use_mclip disabled", e)

    safety_model = (
        safety_mod.load_safety_model(clip_options.clip_model, device) if clip_options.provide_safety_model else None
    )
    violence_detector = (
        safety_mod.load_violence_detector(clip_options.clip_model) if clip_options.provide_violence_detector else None
    )
    aesthetic_embeddings = (
        safety_mod.get_aesthetic_embedding(clip_options.clip_model)
        if clip_options.provide_aesthetic_embeddings
        else None
    )

    folder = clip_options.indice_folder
    indices = {}
    for name in ("image", "text"):
        path = f"{folder}/{name}.index"
        indices[name] = (
            load_index(
                path, clip_options.enable_faiss_memory_mapping, sharded=clip_options.sharded_index, device=device
            )
            if os.path.exists(path)
            else None
        )
    LOGGER.info("loaded indices from %s", folder)

    # serve-time search parameter overrides (the reference pokes nprobe
    # through faiss ParameterSpace)
    for index in indices.values():
        if index is None:
            continue
        if clip_options.nprobe is not None and hasattr(index, "nprobe"):
            index.nprobe = clip_options.nprobe
        if clip_options.rerank_factor is not None and hasattr(index, "rerank_factor"):
            index.rerank_factor = clip_options.rerank_factor

    metadata_provider, ivf_mapping = load_metadata_provider(
        folder,
        clip_options.enable_hdf5,
        clip_options.reorder_metadata_by_ivf_index,
        indices["image"],
        clip_options.columns_to_return,
        clip_options.use_arrow,
    )

    return ClipResource(
        bundle=bundle,
        model_txt_mclip=model_txt_mclip,
        safety_model=safety_model,
        violence_detector=violence_detector,
        aesthetic_embeddings=aesthetic_embeddings,
        metadata_provider=metadata_provider,
        image_index=indices["image"],
        text_index=indices["text"],
        ivf_old_to_new_mapping=ivf_mapping,
        columns_to_return=clip_options.columns_to_return,
        metadata_is_ordered_by_ivf=ivf_mapping is not None,
    )


def load_clip_indices(indices_paths: str, clip_options: ClipOptions) -> Dict[str, ClipResource]:
    with open(indices_paths, "r", encoding="utf-8") as f:
        indices = json.load(f)
    clip_resources = {}
    for name, value in indices.items():
        if isinstance(value, str):
            opts = dict_to_clip_options({"indice_folder": value}, clip_options)
        elif isinstance(value, dict):
            opts = dict_to_clip_options(value, clip_options)
        else:
            raise ValueError("Unknown type for indice_folder")
        clip_resources[name] = load_clip_index(opts)
    return clip_resources

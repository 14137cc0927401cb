"""Writer: buffers embedding batches, writes npy fp16 + parquet partitions.

Same on-disk layout as `clip_retrieval_tpu/inference/writer.py`, so that an
output folder written by either package loads in the other (index build,
metadata providers):

  img_emb/img_emb_<id>.npy     fp16 (N, D)
  text_emb/text_emb_<id>.npy   fp16 (N, D)
  metadata/metadata_<id>.parquet   columns: image_path, caption, + flattened
                                   per-sample metadata JSON

Partition ids are zero-padded to the magnitude of the partition count.
Targets are fsspec URLs (local, s3, gs, hdfs...).
"""

from __future__ import annotations

import json
import math
from io import BytesIO
from typing import Any

import numpy as np


class OutputSink:
    """Buffers one partition's batches and writes them on flush."""

    def __init__(
        self,
        output_folder: str,
        enable_text: bool,
        enable_image: bool,
        enable_metadata: bool,
        partition_id: int,
        output_partition_count: int,
    ):
        import fsspec

        self.enable_text = enable_text
        self.enable_image = enable_image
        self.enable_metadata = enable_metadata
        self.fs, folder = fsspec.core.url_to_fs(output_folder)
        self.img_emb_folder = folder + "/img_emb"
        self.text_emb_folder = folder + "/text_emb"
        self.metadata_folder = folder + "/metadata"
        self.partition_id = partition_id
        self.zpad = int(math.log10(max(1, output_partition_count))) + 1
        if enable_image:
            self.fs.makedirs(self.img_emb_folder, exist_ok=True)
        if enable_text:
            self.fs.makedirs(self.text_emb_folder, exist_ok=True)
        self.fs.makedirs(self.metadata_folder, exist_ok=True)
        self._reset()

    def _reset(self):
        self.image_embeddings: list[np.ndarray] = []
        self.text_embeddings: list[np.ndarray] = []
        self.image_names: list[str] = []
        self.captions: list[str] = []
        self.metadata: list[str] = []
        self.count = 0

    def add(self, sample: dict[str, Any]):
        self.count += sample["image_embs"].shape[0] if self.enable_image else sample["text_embs"].shape[0]
        if self.enable_image:
            self.image_embeddings.append(np.asarray(sample["image_embs"]))
            self.image_names.extend(sample["image_filename"])
        if self.enable_text:
            self.text_embeddings.append(np.asarray(sample["text_embs"]))
            self.captions.extend(sample["text"])
        if self.enable_metadata:
            self.metadata.extend(sample["metadata"])

    def _write_npy(self, mat: np.ndarray, path: str):
        with self.fs.open(path, "wb") as f:
            buf = BytesIO()
            np.save(buf, mat)
            f.write(buf.getbuffer())

    def flush(self):
        if self.count == 0:
            return
        import pandas as pd

        pid = str(self.partition_id).zfill(self.zpad)
        cols: dict[str, list] = {}
        if self.enable_image:
            self._write_npy(np.concatenate(self.image_embeddings), f"{self.img_emb_folder}/img_emb_{pid}.npy")
            cols["image_path"] = self.image_names
        if self.enable_text:
            self._write_npy(np.concatenate(self.text_embeddings), f"{self.text_emb_folder}/text_emb_{pid}.npy")
            cols["caption"] = self.captions
        df = pd.DataFrame(cols)
        if self.enable_metadata:
            parsed = pd.json_normalize([json.loads(m) for m in self.metadata])
            parsed = parsed.drop(columns=set(["caption", "metadata", "image_path"]) & set(parsed.keys()))
            df = df.join(parsed)
        with self.fs.open(f"{self.metadata_folder}/metadata_{pid}.parquet", "wb") as f:
            df.to_parquet(f)
        self._reset()


class NumpyWriter:
    """Per-partition writer facade."""

    def __init__(
        self,
        partition_id: int,
        output_folder: str,
        enable_text: bool,
        enable_image: bool,
        enable_metadata: bool,
        output_partition_count: int,
    ):
        self.sink = OutputSink(
            output_folder,
            enable_text,
            enable_image,
            enable_metadata,
            partition_id,
            output_partition_count,
        )

    def __call__(self, batch: dict[str, Any]):
        self.sink.add(batch)

    def flush(self):
        self.sink.flush()

"""Worker: owns one device and runs a list of partition tasks.

Counterpart of `clip_retrieval_tpu/inference/worker.py`.  The model is
loaded once per worker, on `device` ("cuda" by default; it raises when no GPU
is visible), and reused across tasks.
"""

from __future__ import annotations

from typing import Sequence

from .logger import LoggerWriter
from .mapper import ClipMapper
from .reader import FilesReader, WebdatasetReader
from .runner import Runner
from .staging import DeviceStagingReader
from .writer import NumpyWriter


def worker(
    tasks: Sequence[int],
    input_dataset,
    output_folder: str,
    output_partition_count: int,
    input_format: str = "files",
    cache_path: str | None = None,
    batch_size: int = 256,
    num_prepro_workers: int = 8,
    enable_text: bool = True,
    enable_image: bool = True,
    enable_metadata: bool = False,
    wds_image_key: str = "jpg",
    wds_caption_key: str = "txt",
    clip_model: str = "ViT-B/32",
    checkpoint: str | None = None,
    use_mclip: bool = False,
    mclip_model: str = "",
    compute_dtype: str = "auto",
    device: str = "cuda",
):
    """Run the given output-partition tasks sequentially on this device."""
    print(f"worker: {len(tasks)} tasks {list(tasks)[:8]}...", flush=True)

    mapper = ClipMapper(
        enable_image=enable_image,
        enable_text=enable_text,
        clip_model=clip_model,
        checkpoint=checkpoint,
        use_mclip=use_mclip,
        mclip_model=mclip_model,
        batch_size=batch_size,
        compute_dtype=compute_dtype,
        device=device,
    )
    bundle = mapper.bundle

    def reader_builder(sampler):
        kwargs = dict(
            sampler=sampler,
            preprocess=bundle.preprocess,
            tokenizer=lambda texts: bundle.tokenize(texts),
            input_dataset=input_dataset,
            batch_size=batch_size,
            num_prepro_workers=num_prepro_workers,
            enable_text=enable_text,
            enable_image=enable_image,
            enable_metadata=enable_metadata,
        )
        if input_format == "files":
            reader = FilesReader(**kwargs)
        elif input_format == "webdataset":
            reader = WebdatasetReader(
                **kwargs, wds_image_key=wds_image_key, wds_caption_key=wds_caption_key, cache_path=cache_path
            )
        else:
            raise ValueError(f"Unsupported input_format {input_format}")
        # pad + host→device copy one batch ahead of the compute
        return DeviceStagingReader(reader, mapper)

    def writer_builder(partition_id):
        return NumpyWriter(
            partition_id=partition_id,
            output_folder=output_folder,
            enable_text=enable_text,
            enable_image=enable_image,
            enable_metadata=enable_metadata,
            output_partition_count=output_partition_count,
        )

    def logger_builder(partition_id):
        return LoggerWriter(partition_id=partition_id, stats_folder=output_folder + "/stats")

    runner = Runner(
        reader_builder=reader_builder,
        mapper_builder=lambda: mapper,
        writer_builder=writer_builder,
        logger_builder=logger_builder,
        output_partition_count=output_partition_count,
    )
    for task in tasks:
        runner(task)

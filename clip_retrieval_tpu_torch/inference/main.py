"""clip_inference: the batch embedding job entry point.

Counterpart of `clip_retrieval_tpu/inference/main.py`: count samples, derive
output_partition_count = ceil(samples / write_batch_size), brace-expand
webdataset patterns, start the stats aggregator, hand tasks to a
distributor.  Runs on one explicit device ("cuda" by default); with the pod
or slurm strategy, "cuda" is each rank's own card.
"""

from __future__ import annotations

import math

from ..utils.braces import braceexpand

from ..utils.device import resolve_device
from .distributor import make_distributor
from .logger import LoggerReader
from .reader import folder_to_keys


def calculate_partition_count(
    input_format: str,
    input_dataset,
    enable_image: bool,
    enable_text: bool,
    enable_metadata: bool,
    write_batch_size: int,
    wds_number_file_per_input_file: int,
):
    """Returns (partition count, adjusted enable_* toggles)."""
    if input_format == "files":
        keys, text_files, image_files, metadata_files = folder_to_keys(
            input_dataset, enable_text, enable_image, enable_metadata
        )
        enable_text = bool(text_files)
        enable_image = bool(image_files)
        enable_metadata = bool(metadata_files)
        if not (enable_text or enable_image or enable_metadata):
            raise ValueError("no sample found")
        keys, _, _, _ = folder_to_keys(input_dataset, enable_text, enable_image, enable_metadata)
        sample_count = len(keys)
    elif input_format == "webdataset":
        sample_count = len(input_dataset) * wds_number_file_per_input_file
    else:
        raise ValueError(f"Unsupported input_format {input_format}")
    if sample_count == 0:
        raise ValueError("no sample found")
    print(f"The number of samples has been estimated to be {sample_count}")
    return math.ceil(sample_count / write_batch_size), enable_text, enable_image, enable_metadata


def main(
    input_dataset,
    output_folder: str,
    input_format: str = "files",
    cache_path: str | None = None,
    batch_size: int = 256,
    num_prepro_workers: int = 8,
    enable_text: bool = True,
    enable_image: bool = True,
    enable_metadata: bool = False,
    write_batch_size: int = 10**6,
    wds_image_key: str = "jpg",
    wds_caption_key: str = "txt",
    clip_model: str = "ViT-B/32",
    checkpoint: str | None = None,
    mclip_model: str = "",
    use_mclip: bool = False,
    use_jit: bool = True,  # accepted for CLI parity; PyTorch runs eagerly
    compute_dtype: str = "auto",
    distribution_strategy: str = "sequential",
    wds_number_file_per_input_file: int = 10000,
    output_partition_count: int | None = None,
    wandb_project: str = "clip_retrieval",
    enable_wandb: bool = False,
    clip_cache_path: str | None = None,
    slurm_job_name: str | None = None,
    slurm_partition: str | None = None,
    slurm_nodes: int | None = None,
    slurm_job_comment: str | None = None,
    slurm_nodelist: str | None = None,
    slurm_exclude: str | None = None,
    slurm_job_timeout: int | None = None,
    slurm_cache_path: str | None = None,
    slurm_verbose_wait: bool = False,
    device: str = "cuda",
):
    """Compute CLIP embeddings for a folder or webdataset corpus."""
    resolve_device(device)  # fail before any work when the GPU is missing
    if not use_jit:
        print("WARNING: use_jit=False is accepted for CLI parity but ignored — the port runs PyTorch eagerly, "
              "there is nothing to jit")
    if clip_cache_path is not None:
        print("WARNING: clip_cache_path is accepted for CLI parity but ignored — pass the checkpoint path via "
              "clip_model ('ViT-B/32:/path/to/ckpt.pt') or checkpoint instead")
    if input_format == "webdataset":
        patterns = [input_dataset] if isinstance(input_dataset, str) else input_dataset
        input_dataset = [url for pattern in patterns for url in braceexpand(pattern)]

    if output_partition_count is None:
        output_partition_count, enable_text, enable_image, enable_metadata = calculate_partition_count(
            input_format=input_format,
            input_dataset=input_dataset,
            enable_image=enable_image,
            enable_text=enable_text,
            enable_metadata=enable_metadata,
            write_batch_size=write_batch_size,
            wds_number_file_per_input_file=wds_number_file_per_input_file,
        )

    worker_args = dict(
        input_dataset=input_dataset,
        output_folder=output_folder,
        output_partition_count=output_partition_count,
        input_format=input_format,
        cache_path=cache_path,
        batch_size=batch_size,
        num_prepro_workers=num_prepro_workers,
        enable_text=enable_text,
        enable_image=enable_image,
        enable_metadata=enable_metadata,
        wds_image_key=wds_image_key,
        wds_caption_key=wds_caption_key,
        clip_model=clip_model,
        checkpoint=checkpoint,
        use_mclip=use_mclip,
        mclip_model=mclip_model,
        compute_dtype=compute_dtype,
        device=device,
    )
    if distribution_strategy == "slurm":
        worker_args.update(
            slurm_job_name=slurm_job_name,
            slurm_partition=slurm_partition,
            slurm_nodes=slurm_nodes,
            slurm_job_comment=slurm_job_comment,
            slurm_nodelist=slurm_nodelist,
            slurm_exclude=slurm_exclude,
            slurm_job_timeout=slurm_job_timeout,
            slurm_cache_path=slurm_cache_path,
            slurm_verbose_wait=slurm_verbose_wait,
        )
    distributor = make_distributor(distribution_strategy, list(range(output_partition_count)), worker_args)

    logger_reader = LoggerReader(
        stats_folder=output_folder + "/stats", wandb_project=wandb_project, enable_wandb=enable_wandb
    )
    logger_reader.start()
    try:
        distributor()
    finally:
        logger_reader.end()


clip_inference = main

"""Runner: the per-partition read → embed → write hot loop.

Counterpart of `clip_retrieval_tpu/inference/runner.py`: a modulo Sampler
fixes which input items belong to a partition, and the loop reports
per-batch read/inference/write/total durations and sample_count to the
logger.  The mapper reads its embeddings back to the host, so
`inference_duration` covers the device work of the batch.

CRT_PROFILE_DIR=<dir> records partition 0 with `torch.profiler` (CPU and,
where present, CUDA activity) and writes a Chrome trace
`<dir>/trace_partition0.json` plus `<dir>/ops_partition0.txt`, the
per-operator table sorted by self device time (self CPU time without a GPU),
whose "Self CUDA %" column is each operator's share of device time.
"""

from __future__ import annotations

import os
import time
from typing import Callable


class Sampler:
    """Partition i owns every item with index ≡ i (mod partition count)."""

    def __init__(self, output_partition_id: int, output_partition_count: int):
        self.output_partition_id = output_partition_id
        self.output_partition_count = output_partition_count

    def __call__(self, items):
        return [e for i, e in enumerate(items) if i % self.output_partition_count == self.output_partition_id]


def _start_profiler(profile_dir: str):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


class Runner:
    """Wires reader/mapper/writer/logger builders and runs one partition."""

    def __init__(
        self,
        reader_builder: Callable,
        mapper_builder: Callable,
        writer_builder: Callable,
        logger_builder: Callable,
        output_partition_count: int,
    ):
        self.reader_builder = reader_builder
        self.mapper_builder = mapper_builder
        self.writer_builder = writer_builder
        self.logger_builder = logger_builder
        self.output_partition_count = output_partition_count

    def __call__(self, partition_id: int):
        sampler = Sampler(partition_id, self.output_partition_count)
        reader = self.reader_builder(sampler)
        writer = self.writer_builder(partition_id)
        mapper = self.mapper_builder()
        logger = self.logger_builder(partition_id)
        logger.start()
        profile_dir = os.environ.get("CRT_PROFILE_DIR")
        prof = _start_profiler(profile_dir) if profile_dir and partition_id == 0 else None
        try:
            iterator = iter(reader)
            while True:
                begin = time.time()
                t0 = time.perf_counter()
                try:
                    batch = next(iterator)
                except StopIteration:
                    break
                read_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                embeddings = mapper(batch)
                infer_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                writer(embeddings)
                write_s = time.perf_counter() - t0
                end = time.time()
                logger(
                    {
                        "start_time": begin,
                        "end_time": end,
                        "read_duration": read_s,
                        "inference_duration": infer_s,
                        "write_duration": write_s,
                        "total_duration": end - begin,
                        "sample_count": batch.get(
                            "_staged_n",  # device-staged batches are padded
                            batch["image_tensor"].shape[0] if "image_tensor" in batch else batch["text_tokens"].shape[0],
                        ),
                    }
                )
        finally:
            if prof is not None:
                import torch

                prof.stop()
                prof.export_chrome_trace(os.path.join(profile_dir, f"trace_partition{partition_id}.json"))
                sort_by = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
                with open(os.path.join(profile_dir, f"ops_partition{partition_id}.txt"), "w") as f:
                    f.write(prof.key_averages().table(sort_by=sort_by, row_limit=60))
            logger.end()
        writer.flush()

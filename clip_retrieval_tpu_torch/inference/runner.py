"""Runner: the per-partition read → embed → write hot loop.

Counterpart of `clip_retrieval_tpu/inference/runner.py`: a modulo Sampler
fixes which input items belong to a partition, and the loop reports
per-batch read/inference/write/total durations and sample_count to the
logger.  The durations are those of the batch's spans (`utils/trace.py`:
`runner.batch` and its children `runner.read`, `runner.map`,
`runner.write`), the one clock of the loop.  The mapper reads its
embeddings back to the host, so `inference_duration` covers the device work
of the batch.

CRT_PROFILE_DIR=<dir> records partition 0 with `torch.profiler` (CPU and,
where present, CUDA activity) and writes a Chrome trace
`<dir>/trace_partition0.json` plus `<dir>/ops_partition0.txt`, the
per-operator table sorted by self device time (self CPU time without a GPU),
whose "Self CUDA %" column is each operator's share of device time.  The
trace shows the loop's spans as `record_function` ranges beside the kernels.
"""

from __future__ import annotations

import os
from typing import Callable

from ..utils import trace
from .staging import STAGED_KEY


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
    # every thread: the staging thread's spans and copies show too
    all_threads = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(activities=activities, experimental_config=all_threads)
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
            with trace.span("runner.partition"):
                iterator = iter(reader)
                while self._batch(iterator, mapper, writer, logger):
                    pass
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

    @staticmethod
    def _batch(iterator, mapper, writer, logger) -> bool:
        """Read, embed and write one batch; False once the reader is done."""
        with trace.span("runner.batch") as root:
            with trace.span("runner.read") as read:
                batch = next(iterator, None)
                if batch is None:
                    read.drop()
                    root.drop()
                    return False
                seq = batch.get(trace.BATCH_KEY)
                trace.set_batch(trace.next_batch() if seq is None else seq)
            with trace.span("runner.map") as infer:
                embeddings = mapper(batch)
            with trace.span("runner.write") as write:
                writer(embeddings)
            samples = batch.get(
                STAGED_KEY,  # device-staged batches are padded
                batch["image_tensor"].shape[0] if "image_tensor" in batch else batch["text_tokens"].shape[0],
            )
            root.count(samples=samples)
        trace.set_batch(None)
        logger(
            {
                "start_time": root.start_unix_s,
                "end_time": root.end_unix_s,
                "read_duration": read.seconds,
                "inference_duration": infer.seconds,
                "write_duration": write.seconds,
                "total_duration": root.seconds,
                "sample_count": samples,
            }
        )
        return True

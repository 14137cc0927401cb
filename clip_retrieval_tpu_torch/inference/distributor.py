"""Distributors: schedule partition tasks over workers.

Counterpart of `clip_retrieval_tpu/inference/distributor.py`.  Strategies:

- SequentialDistributor — all tasks in this process, on one device.
- PodDistributor — one rank per GPU (torchrun, or one process per card
  with `RANK`/`WORLD_SIZE`/`LOCAL_RANK` set): `init_pod` gives the rank and
  world, `get_task_list` this rank's contiguous block of partitions (the
  reference's SLURM rank math), and the rank's card becomes its current
  device.  Ranks coordinate only through the filesystem, as in the
  reference.
- PysparkDistributor — one Spark task per partition, when pyspark is
  installed.
- SlurmDistributor — in slurm.py: sbatch generation and squeue polling.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from ..parallel.dist import bind_local_device, get_task_list, init_pod, local_rank
from .worker import worker


class SequentialDistributor:
    def __init__(self, tasks: Sequence[int], worker_args: dict[str, Any]):
        self.tasks = list(tasks)
        self.worker_args = worker_args

    def __call__(self):
        worker(tasks=self.tasks, **self.worker_args)


class PodDistributor:
    """Each rank takes a contiguous block of partitions on its own card."""

    def __init__(self, tasks: Sequence[int], worker_args: dict[str, Any]):
        self.tasks = list(tasks)
        self.worker_args = worker_args

    def __call__(self):
        # the card first: an nccl group opened by init_pod binds to the current device
        bind_local_device(self.worker_args.get("device", "cuda"), local_rank())
        rank, world = init_pod()
        mine = get_task_list(len(self.tasks), world, rank)
        worker(tasks=[self.tasks[i] for i in mine], **self.worker_args)


class PysparkDistributor:
    """One Spark task per output partition (reference `distributor.py:23-59`)."""

    def __init__(self, tasks: Sequence[int], worker_args: dict[str, Any]):
        self.tasks = list(tasks)
        self.worker_args = worker_args

    def __call__(self):
        from pyspark.sql import SparkSession  # pylint: disable=import-error

        spark = SparkSession.getActiveSession()
        if spark is None:
            print("No spark session found; creating a local one")
            spark = (
                SparkSession.builder.config("spark.driver.memory", "16G")
                .master("local[1]")
                .appName("clip-retrieval-tpu-torch")
                .getOrCreate()
            )
        worker_args = self.worker_args
        rdd = spark.sparkContext.parallelize(self.tasks, numSlices=len(self.tasks))

        def run(partition_id: int):
            worker(tasks=[partition_id], **worker_args)

        rdd.foreach(run)


def make_distributor(strategy: str, tasks: Sequence[int], worker_args: dict[str, Any]) -> Callable[[], None]:
    if strategy == "sequential":
        return SequentialDistributor(tasks, worker_args)
    if strategy == "pod":
        return PodDistributor(tasks, worker_args)
    if strategy == "pyspark":
        return PysparkDistributor(tasks, worker_args)
    if strategy == "slurm":
        from .slurm import SlurmDistributor

        return SlurmDistributor(tasks, worker_args)
    raise ValueError(f"unknown distribution strategy {strategy!r}")

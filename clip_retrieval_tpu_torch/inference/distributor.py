"""Distributors: schedule partition tasks over workers.

Counterpart of `clip_retrieval_tpu/inference/distributor.py`.  Only the
sequential strategy (all tasks in this process, on one device) is ported;
the multi-host strategies wait for ROADMAP queue 1, item "Scale-out".
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from .worker import worker


class SequentialDistributor:
    def __init__(self, tasks: Sequence[int], worker_args: dict[str, Any]):
        self.tasks = list(tasks)
        self.worker_args = worker_args

    def __call__(self):
        worker(tasks=self.tasks, **self.worker_args)


def make_distributor(strategy: str, tasks: Sequence[int], worker_args: dict[str, Any]) -> Callable[[], None]:
    if strategy == "sequential":
        return SequentialDistributor(tasks, worker_args)
    if strategy in ("pod", "pyspark", "slurm"):
        raise NotImplementedError(
            f"distribution_strategy={strategy!r} is not ported yet (ROADMAP queue 1, 'Scale-out'); use 'sequential'"
        )
    raise ValueError(f"unknown distribution strategy {strategy!r}")

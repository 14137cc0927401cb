"""Multi-host work distribution: the rank math and the process group.

Counterpart of `clip_retrieval_tpu/parallel/dist.py`.  `get_task_list` is
the same contiguous-block split as the reference's SLURM rank worker, kept
as a pure function.  `init_pod` reads the rank and world size from the
launcher's environment (torchrun's `RANK`/`WORLD_SIZE`, or SLURM's
`SLURM_PROCID`/`SLURM_NTASKS`) where the JAX package asks
`jax.distributed`, and opens a `torch.distributed` group when the launcher
gave a rendezvous address (`MASTER_ADDR`).  On GPUs one rank drives one
card: `local_rank` names it and `bind_local_device` makes it the rank's
current CUDA device.
"""

from __future__ import annotations

import datetime
import os
from typing import List

import torch

PG_TIMEOUT = datetime.timedelta(minutes=10)  # rendezvous and collectives of a process group


def get_task_list(num_tasks: int, world_size: int, global_rank: int) -> List[int]:
    """Contiguous block of task ids for this rank; the first `remainder`
    ranks absorb one extra task each."""
    if world_size <= 0:
        raise ValueError("world_size must be positive")
    tasks_per_worker = num_tasks // world_size
    remainder = num_tasks % world_size
    start = global_rank * tasks_per_worker + min(global_rank, remainder)
    count = tasks_per_worker + (1 if global_rank < remainder else 0)
    return list(range(start, start + count))


def _env_int(*names: str, default: int) -> int:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def local_rank() -> int:
    """This rank's card on its host: `LOCAL_RANK` (torchrun) or
    `SLURM_LOCALID`, else 0."""
    return _env_int("LOCAL_RANK", "SLURM_LOCALID", default=0)


def bind_local_device(device: str | torch.device, index: int) -> None:
    """Make card `index` this rank's current CUDA device, so that `device`
    ("cuda") resolves to it; nothing for a CPU device."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(index)


def init_pod() -> tuple[int, int]:
    """(rank, world size) of this process, from `RANK`/`WORLD_SIZE` or
    `SLURM_PROCID`/`SLURM_NTASKS`; (0, 1) when neither is set.

    With `MASTER_ADDR` set and a world of more than one rank it also joins
    the default `torch.distributed` group (nccl with a GPU, bound to the
    current card, which the caller sets first; gloo without), unless one is
    open already.  A failed rendezvous raises: a rank never
    carries on alone when the world says it has peers."""
    rank = _env_int("RANK", "SLURM_PROCID", default=0)
    world = _env_int("WORLD_SIZE", "SLURM_NTASKS", default=1)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a world of {world}")
    if world > 1 and os.environ.get("MASTER_ADDR") and not torch.distributed.is_initialized():
        if torch.cuda.is_available():  # nccl, bound to the rank's current card (set it first)
            kw = {"device_id": torch.device("cuda", torch.cuda.current_device())}
            backend = "nccl"
        else:
            kw, backend = {}, "gloo"
        torch.distributed.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                             timeout=PG_TIMEOUT, **kw)
    return rank, world

"""Device staging: overlap host→device copies with device compute.

Counterpart of `clip_retrieval_tpu/inference/staging.py`, with pinned host
buffers and a side copy stream in place of `jax.device_put`.  A background
thread pads each reader batch to the mapper's fixed shape, copies it into
pinned host memory and issues the host→device copy on its own CUDA stream,
one batch ahead, recording an event.  Before the batch is handed to the
mapper, the consumer's stream waits on that event, so batch N+1 is in flight
while batch N computes.  On the CPU the batch is simply wrapped as tensors.

Each staged batch gets its number (`utils/trace.py`, under
`trace.BATCH_KEY`); the staging thread records `staging.stage` with the
reader's decode counters for the batch, and the consumer `staging.take`,
its wait for the next staged batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ..utils import trace
from .reader import DECODE_KEY

STAGED_KEY = "_staged_n"
_EVENT_KEY = "_staged_event"
_TENSOR_KEYS = ("image_tensor", "text_tokens")


class DeviceStagingReader:
    """Iterates reader batches with image/text tensors staged on the
    mapper's device (padded, under STAGED_KEY = the real row count)."""

    DEPTH = 2  # staged batches in flight ahead of the consumer

    def __init__(self, reader, mapper):
        self.reader = reader
        self.mapper = mapper
        self.device: torch.device = mapper.device
        self.copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _stage(self, batch: dict[str, Any]) -> dict[str, Any]:
        seq = trace.next_batch()
        with trace.span("staging.stage", batch=seq) as stage:
            out = self._pad_and_copy(batch)
            decode = out.pop(DECODE_KEY, None)
            if decode is not None:
                stage.count(**decode)
        out[trace.BATCH_KEY] = seq
        return out

    def _pad_and_copy(self, batch: dict[str, Any]) -> dict[str, Any]:
        out = dict(batch)
        n = None
        for key in _TENSOR_KEYS:
            if key not in batch:
                continue
            arr = batch[key].astype(np.int32) if key == "text_tokens" else batch[key]
            arr, n = self.mapper.pad_batch(arr)
            host = torch.from_numpy(arr)
            if self.copy_stream is None:
                out[key] = host
                continue
            # the caching host allocator keeps a pinned block alive until the
            # copy recorded on it completes, so a fresh buffer per batch is safe
            pinned = host.pin_memory()
            with torch.cuda.stream(self.copy_stream):
                out[key] = pinned.to(self.device, non_blocking=True)
        if self.copy_stream is not None:
            event = torch.cuda.Event()
            event.record(self.copy_stream)
            out[_EVENT_KEY] = event
        out[STAGED_KEY] = n
        return out

    def _handoff(self, item: dict[str, Any]) -> dict[str, Any]:
        """Make the consumer's stream wait for the copy and own the tensors."""
        event = item.pop(_EVENT_KEY, None)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for key in _TENSOR_KEYS:
                if key in item:
                    item[key].record_stream(stream)
        return item

    def __iter__(self) -> Iterator[dict[str, Any]]:
        q: queue.Queue = queue.Queue(maxsize=self.DEPTH)
        sentinel = object()
        error: list[BaseException] = []
        stop = threading.Event()

        source = iter(self.reader)  # here, before the staging thread: a reader's pool forks on this thread

        def producer():
            try:
                for batch in source:
                    if stop.is_set():  # consumer aborted: stop decoding the rest
                        return
                    q.put(self._stage(batch))
            except BaseException as e:  # propagate to consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with trace.span("staging.take") as take:
                    item = q.get()
                    if item is sentinel:
                        take.drop()
                    else:
                        take.batch = item[trace.BATCH_KEY]
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield self._handoff(item)
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
            close = getattr(source, "close", None)
            if close is not None:  # stops the reader's decode workers
                close()

"""Server-side micro-batching: aggregate concurrent requests into one
device batch.

Copy of `clip_retrieval_tpu/back/batching.py`.  The device encodes a
64-query batch in far less than 64 times the time of a 1-query batch, so
under concurrent load the encode and search steps batch.  Request threads
submit payloads; a collector thread drains the queue for up to
`max_wait_ms` (or `max_batch` items) and runs them as one call.  With a
single in-flight request the added latency is bounded by max_wait_ms.

Two-stage pipelining: when `fn_finish` is given, the collector thread only
DISPATCHES the batch (`fn_batch` returns a handle — a CUDA tensor whose
kernels are queued on the device) and a separate finisher thread
materializes results (`fn_finish(handle, n)`, the blocking `.cpu()`
read-back) and resolves waiters.  Batch N+1's host prep + device dispatch
then overlaps batch N's read-back.  The in-flight queue is bounded (depth
2): deeper pipelines only add latency once the device is saturated.

The batch functions run on the collector and finisher threads, so they
enter `torch.inference_mode()` themselves: the mode is per thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional, Sequence


class _Item:
    __slots__ = ("payload", "event", "result", "error")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None


class MicroBatcher:
    """Blocking submit() → batched fn([payloads]) → per-item results."""

    def __init__(
        self,
        fn_batch: Callable[[Sequence[Any]], Any],
        max_batch: int = 64,
        max_wait_ms: float = 3.0,
        name: str = "microbatch",
        fn_finish: Optional[Callable[[Any, int], List[Any]]] = None,
    ):
        self.fn_batch = fn_batch
        self.fn_finish = fn_finish
        self.max_batch = max_batch
        self.name = name
        self.max_wait = max_wait_ms / 1000.0
        self.queue: queue.Queue[_Item] = queue.Queue()
        # observability (/serving-stats): device batches executed / items served
        self.n_batches = 0
        self.n_items = 0
        # raw batch-size histogram {len(items): count} — with the stage
        # timings from /stage-times this lets a load harness reconstruct
        # the device-busy time of a serving window batch by batch
        self.batch_sizes: dict[int, int] = {}
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=name
        )
        self._thread.start()
        if fn_finish is not None:
            # depth-2 in-flight pipeline: one batch materializing, one
            # dispatched behind it
            self._inflight: queue.Queue = queue.Queue(maxsize=2)
            self._finisher = threading.Thread(
                target=self._finish_loop, daemon=True, name=name + "-finish"
            )
            self._finisher.start()

    def submit(self, payload) -> Any:
        item = _Item(payload)
        self.queue.put(item)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    @staticmethod
    def _resolve(items, results):
        if len(results) != len(items):
            # a short/long result list would otherwise leave the surplus
            # waiters resolving to a silent None
            raise RuntimeError(
                f"batch fn returned {len(results)} results for "
                f"{len(items)} payloads"
            )
        for it, res in zip(items, results):
            it.result = res

    @staticmethod
    def _fail(items, e):
        for it in items:
            it.error = e

    def _loop(self):
        import time

        while True:
            items = [self.queue.get()]
            deadline = time.monotonic() + self.max_wait
            while len(items) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    items.append(self.queue.get(timeout=timeout))
                except queue.Empty:
                    break
            self.n_batches += 1
            self.n_items += len(items)
            self.batch_sizes[len(items)] = (
                self.batch_sizes.get(len(items), 0) + 1
            )
            if self.fn_finish is None:
                try:
                    results = self.fn_batch([it.payload for it in items])
                    self._resolve(items, results)
                except BaseException as e:  # propagate per item
                    self._fail(items, e)
                for it in items:
                    it.event.set()
                continue
            # pipelined: dispatch only; the finisher materializes.  A
            # dispatch error resolves this batch immediately and the
            # pipeline keeps running for the next one.
            try:
                handle = self.fn_batch([it.payload for it in items])
            except BaseException as e:
                self._fail(items, e)
                for it in items:
                    it.event.set()
                continue
            self._inflight.put((items, handle))  # blocks at depth 2

    def _finish_loop(self):
        while True:
            items, handle = self._inflight.get()
            try:
                self._resolve(items, self.fn_finish(handle, len(items)))
            except BaseException as e:
                self._fail(items, e)
            for it in items:
                it.event.set()

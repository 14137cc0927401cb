"""Spans and counters of the embedding loop, on the clock of a profiler trace.

The runner, the staging thread, the readers' decode pool and the mapper
record where each batch's time goes:

- `runner.partition`: one runner call, the parent of its batches;
- `runner.batch`: one batch, counter `samples`, with the children
  `runner.read` (holding `staging.take`, the wait for the next staged
  batch), `runner.map` (holding `mapper.enqueue`, both towers queued on the
  device, counter `cpu_ns` = the thread's CPU time in it, and
  `mapper.readback`, the embeddings read back to the host) and
  `runner.write`;
- inside `mapper.enqueue`: `mapper.image` and `mapper.text`, each CLIP
  tower queued, counter `tokens` = rows × the tower's sequence length
  (256 × 257 and 256 × 77 at ViT-L/14, 256 × 729 and 256 × 64 at SigLIP
  So400m/384, 256 × 577 and 256 × 77 at EVA02-L/14-336), `fused` =
  launches of the block's fused kernels (`ops/block_fused.py`), `eager` =
  dense, LayerNorm, rotary and gate calls that took the eager chain, and
  `rope` and `glu` = the launches of the rotary epilogue and of the SwiGLU
  gate among `fused`; inside `mapper.image` `visual.head`, the pooling head of
  a SigLIP image tower (`models/clip.py`);
- `staging.stage`: the staging thread's pad, pin and host→device copy of a
  batch, carrying the reader's decode counters for it (`decode_samples`,
  `decode_wall_ns`, `decode_cpu_ns`, `decode_workers`).

Every span of one batch carries the batch's number, across threads.  The
stats logger's per-batch durations are read from these spans.

Spans are taken on `time.perf_counter_ns()` and exported in unix ns: the
clock of `torch.profiler`'s Chrome trace, whose `ts` (µs) plus
`baseTimeNanoseconds` is unix time.  While a torch profiler is recording,
each span also opens a `torch.profiler.record_function` range of its name,
so a `CRT_PROFILE_DIR` trace shows the spans beside the kernels; with no
profiler running, none is opened.

The recorder is always on.  It keeps the last `RING` spans in memory and
counts those it let go (`dropped()`).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

RING = 65_536
BATCH_KEY = "_trace_batch"  # a staged batch's number, in the batch dict

# unix ns − perf_counter ns, taken once, so spans keep the monotonic clock
# and export on the profiler trace's
_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


class Span:
    """One timed stretch of one thread; a context manager.  `batch` left
    None takes the thread's current batch (`set_batch`) when it ends."""

    __slots__ = ("_rec", "name", "id", "parent", "thread", "batch", "start_ns", "end_ns", "counters", "keep",
                 "_range")

    def __init__(self, rec: Recorder, name: str, batch: int | None):
        self._rec, self.name, self.batch = rec, name, batch
        self.counters: dict[str, int] | None = None
        self.keep = True
        self._range = None

    def __enter__(self) -> Span:
        state = self._rec._state()
        self.id = next(self._rec._ids)
        self.parent = state.stack[-1].id if state.stack else None
        self.thread = threading.get_ident()
        state.stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:  # the range lies within the span
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.end_ns = time.perf_counter_ns()
        state = self._rec._state()
        state.stack.pop()
        if self.batch is None:
            self.batch = state.batch
        if self.keep:
            self._rec._record(self)

    def count(self, **counters: int) -> None:
        """Add to the span's named counters."""
        if self.counters is None:
            self.counters = {}
        for key, value in counters.items():
            self.counters[key] = self.counters.get(key, 0) + value

    def drop(self) -> None:
        """Record nothing for this span (a read that found no batch)."""
        self.keep = False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def start_unix_s(self) -> float:
        return (self.start_ns + _OFFSET_NS) / 1e9

    @property
    def end_unix_s(self) -> float:
        return (self.end_ns + _OFFSET_NS) / 1e9


class Recorder:
    """A bounded ring of ended spans, and each thread's open spans and
    current batch number."""

    def __init__(self, size: int = RING):
        self._ring: collections.deque = collections.deque(maxlen=size)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._batches = itertools.count(1)
        self._local = threading.local()
        self._dropped = 0

    def _state(self):
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.batch = [], None
        return local

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(span)

    def span(self, name: str, batch: int | None = None) -> Span:
        return Span(self, name, batch)

    def next_batch(self) -> int:
        """A new batch number (from 1)."""
        return next(self._batches)

    def set_batch(self, batch: int | None) -> None:
        """The batch this thread works on from now on (None: no batch)."""
        self._state().batch = batch

    def dropped(self) -> int:
        return self._dropped

    def export(self) -> list[dict]:
        """The ring's spans, oldest first, with start and end in unix ns."""
        with self._lock:
            spans = list(self._ring)
        return [
            {"name": s.name, "id": s.id, "parent": s.parent, "thread": s.thread, "batch": s.batch,
             "start_ns": s.start_ns + _OFFSET_NS, "end_ns": s.end_ns + _OFFSET_NS,
             "counters": dict(s.counters or {})}
            for s in spans
        ]


RECORDER = Recorder()
span = RECORDER.span
next_batch = RECORDER.next_batch
set_batch = RECORDER.set_batch
dropped = RECORDER.dropped
export = RECORDER.export

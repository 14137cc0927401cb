"""Data plane: folder and webdataset readers producing host batches.

Copy of `clip_retrieval_tpu/inference/reader.py` (that package's
`inference/__init__.py` imports jax).  Same folder→key join semantics, same
batch dict keys ("image_tensor", "text_tokens", "image_filename", "text",
"metadata"), same skip-on-corrupt-image behaviour and the same partition
Sampler arithmetic on keys (files) or shard urls (webdataset):

- a bounded pool of worker processes decodes and tokenizes ahead of the
  consumer, a run of consecutive items per task.  The workers are forked, so
  they inherit the reader's load function with its preprocess and tokenizer
  (lambdas and closures included) and nothing is pickled but the items; they
  write each sample's arrays into rows of a ring in anonymous shared memory
  and send back only the other values, so decoding runs outside the
  consumer's interpreter lock and a batch costs the consumer one copy out of
  the ring;
- "image_tensor" is **uint8 HWC**; normalization runs on the device inside
  `clip.encode_image`;
- webdataset tar streaming is first-party (stdlib tarfile over fsspec), in
  this process; the workers get each item's bytes;
- each batch carries, under DECODE_KEY, the decode pool's counters for its
  samples: how many were loaded, the summed wall ns of their loads (read,
  decode, resize, tokenize), the workers' CPU ns (thread clock, per task)
  since the previous batch and the pool's worker count.
"""

from __future__ import annotations

import gc
import hashlib
import io
import itertools
import mmap
import multiprocessing
import os
import shutil
import tarfile
import time
import weakref
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from ..models.preprocess import decode_resize_center_crop
from ..native import get_decode_lib

IMG_EXTS = ("png", "jpg", "jpeg", "bmp", "webp")
DECODE_KEY = "_decode"


def folder_to_keys(
    folder: str,
    enable_text: bool = True,
    enable_image: bool = True,
    enable_metadata: bool = False,
):
    """Glob a folder; join available modalities on the shared relative key.

    Returns (sorted keys, text_files, image_files, metadata_files) — same
    shape as the reference (`reader.py:10-51`)."""
    path = Path(folder)
    text_files = image_files = metadata_files = None
    if enable_text:
        text_files = {
            p.relative_to(path).as_posix(): p for p in path.glob("**/*.txt")
        }
    if enable_image:
        image_files = {}
        for ext in IMG_EXTS:
            for pattern in (f"**/*.{ext}", f"**/*.{ext.upper()}"):
                for p in path.glob(pattern):
                    image_files[p.relative_to(path).as_posix()] = p
    if enable_metadata:
        metadata_files = {
            p.relative_to(path).as_posix(): p for p in path.glob("**/*.json")
        }

    keys = None
    for enabled, files in (
        (enable_text, text_files),
        (enable_image, image_files),
        (enable_metadata, metadata_files),
    ):
        if enabled:
            keyset = {k.rsplit(".", 1)[0] for k in files}
            keys = keyset if keys is None else keys & keyset
    keys = sorted(keys or [])

    def rekey(files):
        if files is None:
            return None
        return {k.rsplit(".", 1)[0]: v for k, v in files.items()}

    return keys, rekey(text_files), rekey(image_files), rekey(metadata_files)


def _shared_ring(rows: int, shape: tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    """`rows` zeroed rows of `shape` in anonymous shared memory: a process
    forked after this writes where this process reads.  The mapping has no
    name, so nothing outlives the processes that map it."""
    count = rows * int(np.prod(shape))
    buf = mmap.mmap(-1, max(count * dtype.itemsize, 1))
    return np.frombuffer(buf, dtype, count).reshape(rows, *shape)


# (load fn, rings, other keys) in a decode worker process, inherited through fork
_JOB: tuple | None = None


def _start_worker(*job):
    global _JOB
    gc.freeze()  # the collector leaves the parent's objects alone: no copy-on-write, no finalizers here
    _JOB = job


def _load_chunk(items: list, slots: list[int]):
    """Load a run of consecutive items in a decode worker.  Each good
    sample's arrays go to row `slots[i]` of their ring; its other values
    come back.  Returns the positions of the good items, their other values
    by key, each item's load wall ns, and the worker's CPU ns for the run."""
    fn, rings, keys = _JOB
    cpu = time.thread_time_ns()
    good: list[int] = []
    walls: list[int] = []
    values: dict[str, list] = {k: [] for k in keys}
    for i, (item, slot) in enumerate(zip(items, slots)):
        t0 = time.perf_counter_ns()
        out = fn(item)
        if out is not None:
            for k, ring in rings.items():
                arr = np.asarray(out[k])
                if arr.shape != ring.shape[1:] or arr.dtype != ring.dtype:
                    raise ValueError(f"{k} is {arr.dtype}{list(arr.shape)} where the first sample's was "
                                     f"{ring.dtype}{list(ring.shape[1:])}")
                ring[slot] = arr
            for k, vals in values.items():
                vals.append(out[k])
            good.append(i)
        walls.append(time.perf_counter_ns() - t0)
    return good, values, walls, time.thread_time_ns() - cpu


class _DecodePool:
    """Batches of `batch_size` good samples, in item order, loaded by a pool
    of forked worker processes.

    The first good sample is loaded here first: its arrays fix the ring's
    rows (it is loaded again by a worker, so every handed-out sample comes
    from the pool).  Then `depth` items at most are in flight, in tasks of
    `batch_size // workers` consecutive items; each item holds a ring row
    until the batch it joins is copied out, so the ring never runs short.
    `stop` terminates the workers and drops the ring; a worker that dies
    raises `BrokenProcessPool` in `batches`."""

    def __init__(self, items: Iterable, fn: Callable, num_workers: int, batch_size: int):
        if "fork" not in multiprocessing.get_all_start_methods():
            raise RuntimeError("the decode pool forks its workers, and this platform cannot fork")
        self.workers = max(1, num_workers)
        self.batch_size = batch_size
        self.depth = max(2 * batch_size, 64)
        self.chunk = max(1, batch_size // self.workers)
        self.items = iter(items)
        self.futures: deque = deque()
        self.in_flight = 0
        self.loaded = self.wall_ns = self.cpu_ns = 0
        self.pool = None
        self.keys: list[str] = []
        self.rings: dict[str, np.ndarray] = {}
        self.other_keys: list[str] = []
        first = self._probe(fn)
        if first is None:  # nothing loads: no batch
            return
        self.keys = list(first)
        rows = self.depth + batch_size + 2 * self.chunk
        self.rings = {k: _shared_ring(rows, v.shape, v.dtype) for k, v in first.items() if isinstance(v, np.ndarray)}
        self.other_keys = [k for k in self.keys if k not in self.rings]
        self.free = deque(range(rows))
        get_decode_lib()  # resolved once here; the workers inherit the answer instead of each retrying a build
        self.pool = ProcessPoolExecutor(self.workers, mp_context=multiprocessing.get_context("fork"),
                                        initializer=_start_worker, initargs=(fn, self.rings, self.other_keys))
        try:
            self._refill()  # the first task forks the workers, on the caller's thread
        except BaseException:
            self.stop()
            raise

    def _probe(self, fn):
        """Load items here up to the first good one, which goes back at the
        head of the items; the ones that fail count as loaded here."""
        for item in self.items:
            t0, cpu = time.perf_counter_ns(), time.thread_time_ns()
            out = fn(item)
            if out is not None:
                self.items = itertools.chain([item], self.items)
                return out
            self.loaded += 1
            self.wall_ns += time.perf_counter_ns() - t0
            self.cpu_ns += time.thread_time_ns() - cpu
        return None

    def _refill(self):
        while self.in_flight < self.depth:
            items = list(itertools.islice(self.items, self.chunk))
            if not items:
                return
            slots = [self.free.popleft() for _ in items]
            self.futures.append((self.pool.submit(_load_chunk, items, slots), slots))
            self.in_flight += len(items)

    def _take_counters(self) -> dict[str, int]:
        counters = {"decode_samples": self.loaded, "decode_wall_ns": self.wall_ns, "decode_cpu_ns": self.cpu_ns,
                    "decode_workers": self.workers}
        self.loaded = self.wall_ns = self.cpu_ns = 0
        return counters

    def _batch(self, slots: list[int], values: dict[str, list]) -> dict[str, Any]:
        rows = np.asarray(slots)
        out = {k: self.rings[k][rows] if k in self.rings else values[k] for k in self.keys}  # copies out
        out[DECODE_KEY] = self._take_counters()
        return out

    def batches(self):
        try:
            slots: list[int] = []
            values: dict[str, list] = {k: [] for k in self.other_keys}
            while self.futures:
                future, chunk_slots = self.futures.popleft()
                self.in_flight -= len(chunk_slots)
                good, vals, walls, cpu = future.result()
                self._refill()
                kept = set(good)
                self.free.extend(s for i, s in enumerate(chunk_slots) if i not in kept)
                self.cpu_ns += cpu
                pos = g = 0
                while pos < len(walls):
                    take = good[g : g + self.batch_size - len(slots)]
                    full = len(slots) + len(take) == self.batch_size
                    end = take[-1] + 1 if full else len(walls)
                    slots.extend(chunk_slots[i] for i in take)
                    for k, v in values.items():
                        v.extend(vals[k][g : g + len(take)])
                    self.loaded += end - pos
                    self.wall_ns += sum(walls[pos:end])
                    g, pos = g + len(take), end
                    if full:
                        yield self._batch(slots, values)
                        self.free.extend(slots)
                        slots, values = [], {k: [] for k in values}
            if slots:
                yield self._batch(slots, values)
        finally:
            self.stop()

    def stop(self):
        pool, self.pool = self.pool, None
        if pool is None:
            return
        self.futures.clear()
        # the executor has no public call that stops a running worker: end them here
        procs = list((getattr(pool, "_processes", None) or {}).values())
        pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        self.rings = {}


def _end(batches, pool: _DecodePool):
    batches.close()  # runs its `finally` if it started
    pool.stop()


class _Batches:
    """Iterator over a decode pool's batches.  `close()`, or dropping the
    last reference, stops the pool at once: the generator holds the pool
    and nothing holds this object, so no cycle waits for the collector."""

    def __init__(self, pool: _DecodePool):
        self._batches = pool.batches()
        self.close = weakref.finalize(self, _end, self._batches, pool)

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, Any]:
        return next(self._batches)


class _BaseReader:
    """Shared batching logic: per-sample load fn → batches of batch_size.
    Iterating starts the decode pool (forking its workers) on the calling
    thread."""

    batch_size: int
    num_prepro_workers: int

    def _source(self) -> tuple[Iterable, Callable]:
        """The items to load, and the function that loads one (None: skip)."""
        raise NotImplementedError

    def __iter__(self) -> _Batches:
        items, fn = self._source()
        return _Batches(_DecodePool(items, fn, self.num_prepro_workers, self.batch_size))


class FilesReader(_BaseReader):
    """Reads image/text/metadata triples from a folder tree."""

    def __init__(
        self,
        sampler,
        preprocess,  # either int image_size or callable bytes→np.uint8 HWC
        tokenizer,
        input_dataset: str,
        batch_size: int,
        num_prepro_workers: int = 8,
        enable_text: bool = True,
        enable_image: bool = True,
        enable_metadata: bool = False,
    ):
        keys, text_files, image_files, metadata_files = folder_to_keys(
            input_dataset, enable_text, enable_image, enable_metadata
        )
        self.keys = sampler(keys)
        self.text_files = text_files
        self.image_files = image_files
        self.metadata_files = metadata_files
        self.enable_text = enable_text
        self.enable_image = enable_image
        self.enable_metadata = enable_metadata
        self.batch_size = batch_size
        self.num_prepro_workers = num_prepro_workers
        self.preprocess = preprocess
        self.tokenizer = tokenizer

    def _load_one(self, key: str):
        out: dict[str, Any] = {}
        if self.enable_image:
            path = self.image_files[key]
            try:
                data = Path(path).read_bytes()
                if callable(self.preprocess):
                    img = self.preprocess(data)
                else:
                    img = decode_resize_center_crop(data, self.preprocess)
            except Exception as e:  # corrupt image → skip sample
                print(f"Failed to load image {path}. Error: {e}. Skipping.")
                return None
            out["image_filename"] = str(path)
            out["image_tensor"] = img
        if self.enable_text:
            caption = Path(self.text_files[key]).read_text()
            out["text"] = caption
            out["text_tokens"] = self.tokenizer([caption])[0]
        if self.enable_metadata:
            out["metadata"] = Path(self.metadata_files[key]).read_text()
        return out

    def _source(self):
        return self.keys, self._load_one


def _base_plus_ext(name: str):
    """webdataset key split: basename up to the first dot."""
    slash = name.rfind("/")
    dot = name.find(".", slash + 1)
    if dot < 0:
        return name, ""
    return name[:dot], name[dot + 1 :]


class ShardCache:
    """Local tar-shard cache with a size bound (reference `reader.py:142`:
    webdataset's `cache_dir`/`cache_size=10**10`).  Remote shards are
    copied next to the compute once; re-reads hit the local disk.  When
    adding a shard would exceed the bound, least-recently-used cached
    shards are evicted first (never the shard being added)."""

    def __init__(self, path: str, size_bytes: int = 10**10):
        self.path = path
        self.size_bytes = size_bytes
        os.makedirs(path, exist_ok=True)

    def _local_name(self, url: str) -> str:
        h = hashlib.sha1(url.encode()).hexdigest()[:12]
        return os.path.join(
            self.path, f"{h}_{os.path.basename(url.rstrip('/'))}"
        )

    # in-flight .wip downloads older than this are treated as orphans from
    # killed workers and become evictable again
    WIP_ORPHAN_SECONDS = 3600.0

    def _evict_to_fit(self, incoming: int):
        import time

        entries = []
        total = 0
        now = time.time()
        for name in os.listdir(self.path):
            p = os.path.join(self.path, name)
            try:
                if not os.path.isfile(p):
                    continue
                st = os.stat(p)
            except OSError:
                continue  # another worker evicted it between listdir and stat
            if ".wip." in name and now - st.st_mtime < self.WIP_ORPHAN_SECONDS:
                # never evict another worker's live download; stale .wip
                # files (SIGKILLed workers skip the cleanup) count and evict
                # like any cached file so they can't grow the dir unbounded
                continue
            entries.append((st.st_atime, st.st_size, p))
            total += st.st_size
        entries.sort()
        for _, size, p in entries:
            if total + incoming <= self.size_bytes:
                break
            try:
                os.remove(p)
                total -= size
            except OSError:
                pass

    def fetch(self, url: str) -> str:
        """Return a local path for the shard, copying it in if needed."""
        local = self._local_name(url)
        if os.path.exists(local):
            os.utime(local)  # refresh LRU recency
            return local
        import fsspec
        import uuid

        # per-process unique tmp: concurrent workers sharing a cache dir
        # must not interleave writes into one .wip file; each downloads its
        # own copy and the last atomic os.replace wins (identical content)
        tmp = f"{local}.wip.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        try:
            with fsspec.open(url, "rb") as src, open(tmp, "wb") as dst:
                shutil.copyfileobj(src, dst, 1 << 20)
            self._evict_to_fit(os.path.getsize(tmp))
            os.replace(tmp, local)  # write-then-rename, like the stats logger
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return local


import contextlib


@contextlib.contextmanager
def _open_shard(url: str):
    """Byte stream for one shard url.

    `pipe:<shell command>` streams the command's stdout — the webdataset
    convention the reference uses for hdfs/s3 shards (its README.md:257-265:
    `pipe:hdfs dfs -cat path`, `pipe:aws s3 cp --quiet s3://... -`); every
    other url goes through fsspec (local, s3://, gs://, hdfs://, http)."""
    if url.startswith("pipe:"):
        import subprocess

        proc = subprocess.Popen(
            url[len("pipe:"):], shell=True, stdout=subprocess.PIPE
        )
        consumer_closed = None
        try:
            yield proc.stdout
        except GeneratorExit:
            # deliberate stop (sample cap): writer exit is expected, silent
            consumer_closed = "stop"
            raise
        except BaseException:
            # error-path teardown (corrupt tar, KeyboardInterrupt): the
            # writer's exit is still OUR doing — raising over the in-flight
            # exception would mask it — but its code is worth logging,
            # since a mid-stream command failure often FIRST surfaces as a
            # consumer-side truncated-tar error
            consumer_closed = "error"
            raise
        finally:
            proc.stdout.close()
            rc = proc.wait()
            # -13 (raw SIGPIPE) and 141 (shell 128+13) are pipe-closed
            # teardown, e.g. trailing tar padding left unread.  Every other
            # nonzero exit on a fully-consumed stream raises: a command
            # killed mid-stream (OOM -9, drain -15, auth failure 1) can
            # leave a truncated-but-valid-looking tar whose missing
            # samples would otherwise vanish silently.
            if rc not in (0, None, -13, 141):
                if consumer_closed is not None:
                    # consumer-initiated teardown: never mask the in-flight
                    # exception, but always log the writer's exit — a
                    # mid-stream command failure (expired creds) often
                    # FIRST surfaces downstream, and this one line is the
                    # root-cause breadcrumb
                    print(f"note: pipe shard command exited rc={rc}: {url}")
                else:
                    raise RuntimeError(
                        f"pipe shard command failed rc={rc}: {url}"
                    )
    else:
        import fsspec

        with fsspec.open(url, "rb") as f:
            yield f


def _iter_tar_samples(url: str, cache: ShardCache | None = None):
    """Stream (key, {ext: bytes}) groups from one tar shard
    (local/fsspec/pipe:)."""
    if cache is not None and not url.startswith("pipe:"):
        url = cache.fetch(url)
    with _open_shard(url) as f:
        with tarfile.open(fileobj=f, mode="r|*") as tf:
            cur_key, cur = None, {}
            for member in tf:
                if not member.isfile():
                    continue
                key, ext = _base_plus_ext(member.name)
                if key != cur_key:
                    if cur_key is not None and cur:
                        yield cur_key, cur
                    cur_key, cur = key, {}
                data = tf.extractfile(member)
                if data is not None:
                    cur[ext] = data.read()
            if cur_key is not None and cur:
                yield cur_key, cur


class WebdatasetReader(_BaseReader):
    """Streams image/text/json samples from webdataset tar shards.

    The partition sampler selects *shards* (same contract as the reference:
    `input_sampler(urls)`, `reader.py:136`).
    """

    def __init__(
        self,
        sampler,
        preprocess,
        tokenizer,
        input_dataset: Sequence[str] | str,
        batch_size: int,
        num_prepro_workers: int = 8,
        enable_text: bool = True,
        enable_image: bool = True,
        enable_metadata: bool = False,
        wds_image_key: str = "jpg",
        wds_caption_key: str = "txt",
        cache_path: str | None = None,
    ):
        urls = [input_dataset] if isinstance(input_dataset, str) else list(
            input_dataset
        )
        self.urls = sampler(urls)
        self.batch_size = batch_size
        self.num_prepro_workers = num_prepro_workers
        self.preprocess = preprocess
        self.tokenizer = tokenizer
        self.enable_text = enable_text
        self.enable_image = enable_image
        self.enable_metadata = enable_metadata
        self.image_key = wds_image_key
        self.caption_key = wds_caption_key
        # local shard cache (reference reader.py:142: 10 GB webdataset cache)
        self.cache = ShardCache(cache_path) if cache_path else None

    def _decode_one(self, item):
        key, files = item
        out: dict[str, Any] = {}
        try:
            if self.enable_image:
                data = files[self.image_key]
                if callable(self.preprocess):
                    img = self.preprocess(data)
                else:
                    img = decode_resize_center_crop(data, self.preprocess)
                out["image_filename"] = key
                out["image_tensor"] = img
            if self.enable_text:
                caption = files[self.caption_key].decode("utf-8")
                out["text"] = caption
                out["text_tokens"] = self.tokenizer([caption])[0]
            if self.enable_metadata:
                out["metadata"] = files["json"].decode("utf-8")
        except Exception as e:
            print(f"Failed to decode sample {key}: {e}. Skipping.")
            return None
        return out

    def _raw_items(self):
        for url in self.urls:
            try:
                yield from _iter_tar_samples(url, self.cache)
            except Exception as e:
                print(f"Failed to read shard {url}: {e}. Skipping shard.")

    def _filtered_items(self):
        for key, files in self._raw_items():
            if self.enable_image and self.image_key not in files:
                continue
            if self.enable_text and self.caption_key not in files:
                continue
            if self.enable_metadata and "json" not in files:
                continue
            yield key, files

    def _source(self):
        return self._filtered_items(), self._decode_one

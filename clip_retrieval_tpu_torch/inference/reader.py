"""Data plane: folder and webdataset readers producing host batches.

Copy of `clip_retrieval_tpu/inference/reader.py` (that package's
`inference/__init__.py` imports jax).  Same folder→key join semantics, same
batch dict keys ("image_tensor", "text_tokens", "image_filename", "text",
"metadata"), same skip-on-corrupt-image behaviour and the same partition
Sampler arithmetic on keys (files) or shard urls (webdataset):

- a bounded thread pool decodes and tokenizes ahead of the consumer (PIL
  and the native decoder release the GIL);
- "image_tensor" is **uint8 HWC**; normalization runs on the device inside
  `clip.encode_image`;
- webdataset tar streaming is first-party (stdlib tarfile over fsspec);
- each batch carries, under DECODE_KEY, the decode pool's counters for its
  samples: how many were loaded, the summed wall ns of their loads (read,
  decode, resize, tokenize), the pool threads' CPU ns since the previous
  batch and the pool's worker count.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import tarfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from collections import deque
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from ..models.preprocess import decode_resize_center_crop

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


def _collate(samples: list[dict[str, Any]]) -> dict[str, Any]:
    """Stack per-sample dicts into a batch; numeric fields → arrays."""
    out: dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


class _PrefetchIterator:
    """Ordered, bounded-depth parallel map over an item iterator.  It counts
    the results handed out and sums the wall ns of each call of `fn`, and
    reads its worker threads' CPU clocks, until `take_counters()` starts
    the next count (one clock read per worker and batch, not per sample:
    a thread's CPU clock is a system call)."""

    def __init__(self, items, fn, num_workers: int, depth: int):
        self.items = iter(items)
        self.fn = fn
        self.workers = max(1, num_workers)
        self._clocks: list[int] = []  # the workers' CPU clocks, as each starts
        self.pool = ThreadPoolExecutor(max_workers=self.workers, initializer=self._add_clock)
        self.depth = depth
        self.futures: deque = deque()
        self.loaded = self.wall_ns = self.cpu_ns = 0
        self._cpu_at_end: int | None = None  # read before the workers stop

    def _add_clock(self):
        self._clocks.append(time.pthread_getcpuclockid(threading.get_ident()))

    def _timed(self, item):
        wall = time.perf_counter_ns()
        return self.fn(item), time.perf_counter_ns() - wall

    def _next_result(self):
        out, wall = self.futures.popleft().result()
        self.loaded += 1
        self.wall_ns += wall
        return out

    def _pool_cpu_ns(self) -> int:
        return sum(time.clock_gettime_ns(c) for c in list(self._clocks))

    def take_counters(self) -> dict[str, int]:
        """The counts since the last call: samples handed out, their loads'
        wall ns, the workers' CPU ns, and the worker count."""
        cpu_ns = self._cpu_at_end if self._cpu_at_end is not None else self._pool_cpu_ns()
        counters = {"decode_samples": self.loaded, "decode_wall_ns": self.wall_ns,
                    "decode_cpu_ns": cpu_ns - self.cpu_ns, "decode_workers": self.workers}
        self.loaded = self.wall_ns = 0
        self.cpu_ns = cpu_ns
        return counters

    def __iter__(self):
        try:
            for item in self.items:
                self.futures.append(self.pool.submit(self._timed, item))
                if len(self.futures) >= self.depth:
                    yield self._next_result()
            while self.futures:
                yield self._next_result()
        finally:
            self._cpu_at_end = self._pool_cpu_ns()
            self.pool.shutdown(wait=False, cancel_futures=True)


class _BaseReader:
    """Shared batching logic: per-sample load fn → batches of batch_size."""

    batch_size: int
    num_prepro_workers: int

    def _sample_iter(self) -> _PrefetchIterator:
        raise NotImplementedError

    def __iter__(self):
        buf: list[dict[str, Any]] = []
        samples = self._sample_iter()
        for sample in samples:
            if sample is None:  # corrupt image etc. — skip
                continue
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield {**_collate(buf), DECODE_KEY: samples.take_counters()}
                buf = []
        if buf:
            yield {**_collate(buf), DECODE_KEY: samples.take_counters()}


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

    def _sample_iter(self):
        depth = max(2 * self.batch_size, 64)
        return _PrefetchIterator(self.keys, self._load_one, self.num_prepro_workers, depth)


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

    def _sample_iter(self):
        depth = max(2 * self.batch_size, 64)
        return _PrefetchIterator(self._filtered_items(), self._decode_one, self.num_prepro_workers, depth)

"""The port's reader on the CPU (`clip_retrieval_tpu_torch/inference/reader.py`):
batches of the next `batch_size` good samples in item order, across the
decode pool's tasks, the same batches as the JAX package's reader on the same
corpus, with the pixels of the preprocess called directly; the pool's forked
workers take lambdas without pickling them, and leave no process and no
shared memory behind, however the iterator ends."""

from __future__ import annotations

import gc
import multiprocessing
import os
import signal
import sys
import threading
import time
from concurrent.futures.process import BrokenProcessPool
from pathlib import Path

import numpy as np
import pytest

from clip_retrieval_tpu_torch.inference.reader import DECODE_KEY, FilesReader, WebdatasetReader
from clip_retrieval_tpu_torch.models.preprocess import _pil_decode_resize_crop, decode_resize_center_crop
from clip_retrieval_tpu_torch.models.tokenizer import CLIPTokenizer

from tests.test_inference.fixtures import make_files_corpus, make_tar_corpus

SIZE = 24
N = 29
KEYS = {"image_tensor", "text_tokens", "image_filename", "text", DECODE_KEY}
TOKENIZER = CLIPTokenizer.byte_fallback()


def tokenize(texts):
    return TOKENIZER(texts, 16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_files_corpus(str(tmp_path_factory.mktemp("corpus")), n=N, with_meta=True)


def _reader(folder, bs, workers=3, preprocess=SIZE, **kw):
    return FilesReader(lambda keys: keys, preprocess, lambda texts: tokenize(texts), folder, batch_size=bs,
                       num_prepro_workers=workers, **kw)


def _files(batches):
    return [f for b in batches for f in b["image_filename"]]


def _expected(folder, skip=()):
    names = sorted(n for n in os.listdir(folder) if n.endswith(".jpg"))
    return [os.path.join(folder, n) for n in names if n not in skip]


def _children() -> set[int]:
    """Live child processes of this process, by pid (every thread's)."""
    pids: set[int] = set()
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/children") as f:
                pids.update(int(p) for p in f.read().split())
        except FileNotFoundError:  # the thread ended since the listing
            pass
    return pids


def _shared_maps() -> int:
    """Anonymous shared mappings of this process."""
    with open("/proc/self/maps") as f:
        return sum("/dev/zero (deleted)" in line for line in f)


@pytest.mark.parametrize("bs,workers", [(4, 3), (5, 2), (7, 3), (29, 8), (64, 3)])
def test_batches_keep_item_order_across_tasks(corpus, bs, workers):
    """Tasks of bs // workers items; batch sizes that do not divide them."""
    batches = list(_reader(corpus, bs, workers))
    assert [len(b["image_filename"]) for b in batches] == [bs] * (N // bs) + ([N % bs] if N % bs else [])
    assert _files(batches) == _expected(corpus)
    for b in batches:
        assert set(b) == KEYS
        assert b["image_tensor"].dtype == np.uint8 and b["image_tensor"].shape[1:] == (SIZE, SIZE, 3)
        assert b["text"] == [f"caption number {int(os.path.basename(f)[4:7])}" for f in b["image_filename"]]
        np.testing.assert_array_equal(b["text_tokens"], tokenize(b["text"]))


def test_metadata_rides_with_its_sample(corpus):
    batches = list(_reader(corpus, 6, enable_metadata=True))
    assert set(batches[0]) == KEYS | {"metadata"}
    for b in batches:
        for f, meta in zip(b["image_filename"], b["metadata"]):
            assert f'"idx": {int(os.path.basename(f)[4:7])}' in meta


@pytest.mark.parametrize("bad", [(0,), (2, 3), (5, 6, 7, 8), (0, 1, 27, 28)])
def test_corrupt_images_are_skipped_at_task_boundaries(tmp_path, bad):
    """Tasks of 3 items (batch 6, 2 workers): corrupt items at a task's end,
    its start, across tasks, first (the item that fixes the ring's rows) and
    last; a batch is the next 6 good samples."""
    folder = make_files_corpus(str(tmp_path / "c"), n=N)
    skip = {f"img_{i:03d}.jpg" for i in bad}
    for name in skip:
        with open(os.path.join(folder, name), "wb") as f:
            f.write(b"not a jpeg")
    batches = list(_reader(folder, 6, workers=2))
    good = _expected(folder, skip)
    assert _files(batches) == good
    assert [len(b["image_filename"]) for b in batches[:-1]] == [6] * (len(batches) - 1)
    assert sum(b[DECODE_KEY]["decode_samples"] for b in batches) == N  # the skipped ones count as loaded


@pytest.mark.parametrize("preprocess", ["size", "closure"])
def test_pixels_are_the_preprocess_called_directly(corpus, preprocess):
    fn = SIZE if preprocess == "size" else (lambda data: _pil_decode_resize_crop(data, SIZE))
    batches = list(_reader(corpus, 8, preprocess=fn))
    for b in batches:
        for f, img in zip(b["image_filename"], b["image_tensor"]):
            with open(f, "rb") as fh:
                data = fh.read()
            want = decode_resize_center_crop(data, SIZE) if preprocess == "size" else fn(data)
            np.testing.assert_array_equal(img, want)


def test_webdataset_batches_and_pixels(tmp_path):
    urls = make_tar_corpus(str(tmp_path / "wds"), sizes=(5, 4, 6, 3))
    reader = WebdatasetReader(lambda u: u, SIZE, lambda texts: tokenize(texts), urls, batch_size=4,
                              num_prepro_workers=2)
    batches = list(reader)
    assert _files(batches) == [f"{i:05d}" for i in range(18)]
    assert [len(b["image_filename"]) for b in batches] == [4, 4, 4, 4, 2]
    from tests.test_inference.fixtures import make_image

    for b in batches:
        assert set(b) == KEYS
        for key, img, text in zip(b["image_filename"], b["image_tensor"], b["text"]):
            np.testing.assert_array_equal(img, decode_resize_center_crop(make_image(int(key)), SIZE))
            assert text == f"caption number {int(key)}"
        np.testing.assert_array_equal(b["text_tokens"], tokenize(b["text"]))


def test_decode_counters_count_each_batch(corpus):
    batches = list(_reader(corpus, 8))
    for b in batches:
        c = b[DECODE_KEY]
        assert set(c) == {"decode_samples", "decode_wall_ns", "decode_cpu_ns", "decode_workers"}
        assert c["decode_samples"] == len(b["image_filename"]) and c["decode_workers"] == 3
        assert c["decode_wall_ns"] > 0 and c["decode_cpu_ns"] >= 0
    assert sum(b[DECODE_KEY]["decode_cpu_ns"] for b in batches) > 0


def test_a_platform_without_fork_raises(corpus, monkeypatch):
    monkeypatch.setattr(multiprocessing, "get_all_start_methods", lambda: ["spawn"])
    with pytest.raises(RuntimeError, match="cannot fork"):
        iter(_reader(corpus, 4))
    assert not _children()


def test_a_sample_unlike_the_first_raises(corpus):
    sizes = iter([SIZE] + [SIZE + 1] * N)
    reader = _reader(corpus, 4, workers=1, preprocess=lambda data: decode_resize_center_crop(data, next(sizes)))
    with pytest.raises(ValueError, match="image_tensor"):
        list(reader)
    assert not _children()


def _slow_reader(folder, delay=0.02):
    def slow(data):
        time.sleep(delay)
        return decode_resize_center_crop(data, SIZE)

    big = FilesReader(lambda keys: keys * 20, slow, lambda texts: tokenize(texts), folder, batch_size=4,
                      num_prepro_workers=2)
    return big


def _staged(reader, n_batches):
    """`n_batches` through the staging reader on the CPU, then its iterator is closed."""
    import torch

    from clip_retrieval_tpu_torch.inference.staging import DeviceStagingReader

    class Mapper:
        device = torch.device("cpu")

        @staticmethod
        def pad_batch(arr):
            return arr, len(arr)

    it = iter(DeviceStagingReader(reader, Mapper()))
    for _ in range(n_batches):
        next(it)
    it.close()


@pytest.mark.parametrize("end", ["close", "dropped", "break", "staging_closed", "error_in_load", "exhausted"])
def test_no_worker_or_shared_memory_outlives_the_iterator(corpus, end):
    before_maps, before_shm = _shared_maps(), set(os.listdir("/dev/shm"))
    assert not _children()
    gc.disable()  # a reference cycle would keep the pool until a collector pass: none runs before the checks
    try:
        _end_iterator(corpus, end, before_maps)
        children, maps = _children(), _shared_maps()
    finally:
        gc.enable()
    assert not children
    assert not multiprocessing.active_children()
    assert maps == before_maps
    assert set(os.listdir("/dev/shm")) == before_shm


def _end_iterator(corpus, end, before_maps):
    if end == "staging_closed":
        _staged(_slow_reader(corpus), 2)
    elif end == "error_in_load":
        calls = []

        def failing(texts):  # a tokenizer's error is no corrupt image: it ends the iteration
            calls.append(1)
            if len(calls) > 2:  # the first item loads in this process, then once more in a worker
                raise OSError("vocabulary gone")
            return tokenize(texts)

        reader = FilesReader(lambda keys: keys, SIZE, failing, corpus, batch_size=4, num_prepro_workers=2)
        with pytest.raises(OSError, match="vocabulary gone"):
            list(reader)
    elif end == "exhausted":
        assert len(_files(_reader(corpus, 4))) == N
    elif end == "break":
        for _ in _slow_reader(corpus):  # the loop's iterator goes with the loop, unclosed
            assert len(_children()) == 2
            break
    else:
        it = iter(_slow_reader(corpus))
        next(it)
        assert len(_children()) == 2 and _shared_maps() > before_maps
        if end == "close":
            it.close()
        else:
            del it  # the last reference going stops the pool


def test_a_killed_worker_raises_in_the_consumer(corpus):
    it = iter(_slow_reader(corpus))
    next(it)
    os.kill(sorted(_children())[0], signal.SIGKILL)
    raised: list[BaseException] = []

    def drain():
        try:
            for _ in it:
                pass
        except BaseException as e:
            raised.append(e)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the consumer hangs on a dead worker"
    assert raised and isinstance(raised[0], BrokenProcessPool)
    assert not _children()


def test_stress_more_workers_than_cores_keep_every_row(corpus):
    """16 workers on tasks of one item over the corpus ten times: a ring row
    rewritten before its batch was copied out shows as another file's pixels."""
    want = {f: decode_resize_center_crop(Path(f).read_bytes(), SIZE) for f in _expected(corpus)}
    reader = FilesReader(lambda keys: keys * 10, SIZE, lambda texts: tokenize(texts), corpus, batch_size=16,
                         num_prepro_workers=16)
    got: list = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=lambda: got.extend(reader), daemon=True)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive(), "the reader did not finish in time"
    assert _files(got) == _expected(corpus) * 10
    for b in got:
        for f, img in zip(b["image_filename"], b["image_tensor"]):
            np.testing.assert_array_equal(img, want[f])
    assert not _children()


def _jax_reader_batches(cls, *args, **kw):
    from clip_retrieval_tpu.inference import reader as jax_reader

    return list(getattr(jax_reader, cls)(*args, **kw))


def _assert_same_batches(ours, theirs):
    """Batch by batch: the same keys, names, captions, tokens and uint8 pixels."""
    assert [len(b["image_filename"]) for b in ours] == [len(b["image_filename"]) for b in theirs]
    for a, b in zip(ours, theirs):
        assert set(a) - {DECODE_KEY} == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]


@pytest.mark.parametrize("bs,workers", [(4, 3), (7, 3), (29, 8), (64, 2)])
@pytest.mark.parametrize("bad", [(), (2, 3), (0, 1, 27, 28)])
def test_files_batches_are_the_jax_readers(tmp_path, bs, workers, bad):
    """The JAX package's FilesReader on the same corpus, corrupt items included."""
    folder = make_files_corpus(str(tmp_path / "c"), n=N, with_meta=True)
    for i in bad:
        with open(os.path.join(folder, f"img_{i:03d}.jpg"), "wb") as f:
            f.write(b"not a jpeg")
    args = (lambda keys: keys, SIZE, lambda texts: tokenize(texts), folder)
    kw = dict(batch_size=bs, num_prepro_workers=workers, enable_metadata=True)
    ours = list(FilesReader(*args, **kw))
    theirs = _jax_reader_batches("FilesReader", *args, **kw)
    _assert_same_batches(ours, theirs)
    assert len(_files(ours)) == N - len(bad)


def _tar_with_faults(path, n, bad, captionless):
    """`n` samples; the `bad` ones carry bytes that are no jpeg, the
    `captionless` ones no caption (the reader filters them before loading)."""
    import io
    import tarfile

    from tests.test_inference.fixtures import make_image

    with tarfile.open(path, "w") as tf:
        for i in range(n):
            files = {"jpg": b"not a jpeg" if i in bad else make_image(i), "json": b'{"idx": %d}' % i}
            if i not in captionless:
                files["txt"] = f"caption number {i}".encode()
            for ext, data in files.items():
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return str(path)


@pytest.mark.parametrize("bs", [3, 4, 16])
@pytest.mark.parametrize("bad,captionless", [((), ()), ((0, 6, 7), (3,)), ((9, 10, 11), (1, 2))])
def test_webdataset_batches_are_the_jax_readers(tmp_path, bs, bad, captionless):
    """The JAX package's WebdatasetReader on the same shards, corrupt and
    captionless items included, across shard boundaries."""
    urls = [_tar_with_faults(tmp_path / "a.tar", 7, bad, captionless),
            _tar_with_faults(tmp_path / "b.tar", 12, [i - 7 for i in bad if i >= 7], ())]
    args = (lambda u: u, SIZE, lambda texts: tokenize(texts), urls)
    kw = dict(batch_size=bs, num_prepro_workers=2, enable_metadata=True)
    ours = list(WebdatasetReader(*args, **kw))
    theirs = _jax_reader_batches("WebdatasetReader", *args, **kw)
    _assert_same_batches(ours, theirs)
    assert _files(ours)  # the comparison saw samples

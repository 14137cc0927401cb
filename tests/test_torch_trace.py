"""The embedding loop's spans and counters (`utils/trace.py`), on the CPU.

A tiny JPEG corpus runs through the port's `Runner` with `FilesReader` →
`DeviceStagingReader` → `ClipMapper` (`test-tiny`) → `NumpyWriter` and the
stats logger.  Every batch has its spans across the runner's and the
staging thread, the stats JSON is what the spans sum to, the decode
counters count the samples loaded, the spans show as `record_function`
ranges in a CPU profiler's trace on the same clock (and open none without a
profiler), and the ring stays bounded.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from clip_retrieval_tpu_torch.inference.logger import LoggerWriter
from clip_retrieval_tpu_torch.inference.mapper import ClipMapper
from clip_retrieval_tpu_torch.inference.reader import FilesReader
from clip_retrieval_tpu_torch.inference.runner import Runner
from clip_retrieval_tpu_torch.inference.staging import DeviceStagingReader
from clip_retrieval_tpu_torch.inference.writer import NumpyWriter
from clip_retrieval_tpu_torch.utils import trace

from tests.test_inference.fixtures import make_files_corpus

N, BS, WORKERS = 37, 8, 8
SIZES = [8, 8, 8, 8, 5]
CHILDREN = {"runner.batch": ["runner.map", "runner.read", "runner.write"], "runner.read": ["staging.take"],
            "runner.map": ["mapper.enqueue", "mapper.readback"], "mapper.enqueue": ["mapper.image", "mapper.text"]}


@pytest.fixture(scope="module")
def mapper():
    return ClipMapper(enable_image=True, enable_text=True, clip_model="test-tiny", batch_size=BS, device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_files_corpus(str(tmp_path_factory.mktemp("corpus")), n=N)


def _run(mapper, corpus, out: str):
    """One runner call over the corpus; returns its spans (the last
    `runner.partition` of the recorder and every span of its batches)."""
    bundle = mapper.bundle

    def reader_builder(sampler):
        reader = FilesReader(sampler=sampler, preprocess=bundle.image_size, tokenizer=bundle.tokenize,
                             input_dataset=corpus, batch_size=BS, num_prepro_workers=WORKERS)
        return DeviceStagingReader(reader, mapper)

    Runner(
        reader_builder=reader_builder,
        mapper_builder=lambda: mapper,
        writer_builder=lambda pid: NumpyWriter(partition_id=pid, output_folder=out, enable_text=True,
                                               enable_image=True, enable_metadata=False, output_partition_count=1),
        logger_builder=lambda pid: LoggerWriter(partition_id=pid, stats_folder=out + "/stats"),
        output_partition_count=1,
    )(0)
    spans = trace.export()
    part = [s for s in spans if s["name"] == "runner.partition"][-1]
    roots = [s for s in spans if s["name"] == "runner.batch" and s["parent"] == part["id"]]
    batches = {r["batch"] for r in roots}
    return part, roots, [s for s in spans if s["batch"] in batches and s["name"] != "runner.partition"]


@pytest.fixture(scope="module")
def run(mapper, corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out"))
    return (*_run(mapper, corpus, out), out)


def test_each_batch_has_its_spans(run):
    part, roots, spans, _ = run
    assert part["batch"] is None
    assert [r["counters"]["samples"] for r in roots] == SIZES
    assert len({r["batch"] for r in roots}) == len(SIZES)
    main = roots[0]["thread"]
    for root in roots:
        mine = [s for s in spans if s["batch"] == root["batch"]]
        by_id = {s["id"]: s for s in mine}
        for parent, names in CHILDREN.items():
            (p,) = [s for s in mine if s["name"] == parent]
            assert sorted(s["name"] for s in mine if s["parent"] == p["id"]) == names
        for s in mine:
            assert s["start_ns"] <= s["end_ns"]
            if s["parent"] in by_id:  # a child lies within its parent
                p = by_id[s["parent"]]
                assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
        (stage,) = [s for s in mine if s["name"] == "staging.stage"]
        assert stage["thread"] != main and stage["parent"] is None
        assert all(s["thread"] == main for s in mine if s is not stage)
        assert root["parent"] == part["id"]
        (enq,) = [s for s in mine if s["name"] == "mapper.enqueue"]
        assert 0 < enq["counters"]["cpu_ns"]
    assert sorted(s["name"] for s in spans) == sorted(
        ["runner.batch", "runner.read", "runner.map", "runner.write", "staging.take", "staging.stage",
         "mapper.enqueue", "mapper.image", "mapper.text", "mapper.readback"] * len(SIZES))


def test_stats_json_is_what_the_spans_sum_to(run):
    _, roots, spans, _ = run
    with open(os.path.join(run[3], "stats", "0.json")) as f:
        stats = json.load(f)

    def seconds(s):
        return (s["end_ns"] - s["start_ns"]) / 1e9

    def child(root, name):
        (s,) = [s for s in spans if s["batch"] == root["batch"] and s["name"] == name]
        return s

    want = {"start_time": 0.0, "end_time": 0.0, "read_duration": 0.0, "inference_duration": 0.0,
            "write_duration": 0.0, "total_duration": 0.0, "sample_count": 0.0}
    for r in roots:  # summed in the logger's order, so equal to the last bit
        want["start_time"] += r["start_ns"] / 1e9
        want["end_time"] += r["end_ns"] / 1e9
        want["read_duration"] += seconds(child(r, "runner.read"))
        want["inference_duration"] += seconds(child(r, "runner.map"))
        want["write_duration"] += seconds(child(r, "runner.write"))
        want["total_duration"] += seconds(r)
        want["sample_count"] += r["counters"]["samples"]
    assert stats == want
    assert stats["sample_count"] == N


def test_decode_counters_count_the_samples_loaded(run):
    _, roots, spans, _ = run
    stages = sorted((s for s in spans if s["name"] == "staging.stage"), key=lambda s: s["batch"])
    assert [s["batch"] for s in stages] == [r["batch"] for r in roots]
    assert [s["counters"]["decode_samples"] for s in stages] == SIZES
    for s in stages:
        c = s["counters"]
        assert c["decode_workers"] == WORKERS
        assert c["decode_wall_ns"] > 0 and c["decode_cpu_ns"] >= 0
    assert sum(s["counters"]["decode_cpu_ns"] for s in stages) > 0  # the pool's CPU, read once a batch


def test_spans_show_in_a_cpu_profile_on_its_clock(mapper, corpus, tmp_path):
    """Each span holds a `record_function` range of its name, within 1 ms of
    its exported unix-ns ends, and the ranges start with their spans (the
    median gap under 1 ms: a thread switch may fall between the span's clock
    read and the range's, so one span alone may see a longer gap)."""
    all_threads = torch.profiler._ExperimentalConfig(profile_all_threads=True)  # the staging thread's too
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm"):  # the process's first range resolves its ops, ~0.3 ms
            pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=all_threads) as prof:
        part, _, spans = _run(mapper, corpus, str(tmp_path / "out"))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    ranges: dict[str, list[tuple[float, float]]] = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            start = float(ev["ts"]) * 1e3 + base
            ranges.setdefault(ev["name"], []).append((start, start + float(ev["dur"]) * 1e3))
    gaps = []
    for s in [part, *spans]:
        held = [r for r in ranges.get(s["name"], []) if s["start_ns"] - 1e6 <= r[0] and r[1] <= s["end_ns"] + 1e6]
        assert held, s["name"]
        gaps.append(min(abs(r[0] - s["start_ns"]) for r in held))
    assert sorted(gaps)[len(gaps) // 2] <= 1e6, gaps


def test_no_profiler_opens_no_range(mapper, corpus, tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    part, _, spans = _run(mapper, corpus, str(tmp_path / "out"))
    assert spans and opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("probe"):
            pass
    assert opened == ["probe"]


def test_the_ring_stays_bounded_and_counts_drops():
    rec = trace.Recorder(size=4)
    for i in range(10):
        with rec.span(f"s{i}", batch=i):
            pass
    spans = rec.export()
    assert [s["name"] for s in spans] == ["s6", "s7", "s8", "s9"] and rec.dropped() == 6
    assert [s["batch"] for s in spans] == [6, 7, 8, 9]


def test_threads_keep_their_own_parents_and_batches():
    """A span's parent is the open span of its own thread, and a span with no
    batch takes its thread's current one when it ends."""
    rec = trace.Recorder()
    barrier = threading.Barrier(4)

    def work(k):
        rec.set_batch(100 + k)
        with rec.span("outer"):
            barrier.wait(timeout=10)
            with rec.span("inner") as inner:
                inner.count(n=k)
                inner.count(n=1)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = rec.export()
    outer = {s["id"]: s for s in spans if s["name"] == "outer"}
    for s in spans:
        if s["name"] == "inner":
            p = outer[s["parent"]]
            assert p["thread"] == s["thread"] and p["batch"] == s["batch"] == 100 + s["counters"]["n"] - 1


@pytest.mark.parametrize("model,heads", [("test-tiny", 0), ("test-tiny-siglip", 1), ("test-tiny-eva", 0)])
def test_tower_spans_count_tokens(model, heads):
    """A mapper call records `mapper.image` and `mapper.text` inside
    `mapper.enqueue`, each counting rows × its sequence length and the fused
    and eager dense/LayerNorm passes; a SigLIP
    image tower adds `visual.head` inside `mapper.image`, a CLIP one (the
    ViT-L/14 structure at test size) none."""
    m = ClipMapper(enable_image=True, enable_text=True, clip_model=model, batch_size=BS, device="cpu")
    cfg = m.bundle.cfg
    n = 3  # padded to the batch size
    batch = {"image_tensor": np.zeros((n, cfg.image_size, cfg.image_size, 3), np.uint8),
             "text_tokens": m.bundle.tokenize(["a cat"] * n), "image_filename": ["f"] * n, "text": ["a cat"] * n}
    before = {s["id"] for s in trace.export()}
    m(batch)
    spans = [s for s in trace.export() if s["id"] not in before]
    by_name = {s["name"]: s for s in spans}
    assert sorted(by_name) == sorted(["mapper.enqueue", "mapper.image", "mapper.text", "mapper.readback"]
                                     + ["visual.head"] * heads)
    enqueue, image, text = by_name["mapper.enqueue"], by_name["mapper.image"], by_name["mapper.text"]
    assert image["parent"] == text["parent"] == enqueue["id"]
    # on the CPU the dense and LayerNorm calls run the plain versions: no kernel launch, no eager chain
    none = {"fused": 0, "eager": 0, "rope": 0, "glu": 0, "gemm": 0, "split": 0}
    assert image["counters"] == {"tokens": BS * (cfg.num_patches + int(cfg.class_token)), **none}
    assert text["counters"] == {"tokens": BS * cfg.context_length, **none}
    if heads:
        assert by_name["visual.head"]["parent"] == image["id"] and cfg.vision_seq_len == 25


def _passes(cfg, tower: str) -> int:
    """Dense, LayerNorm, rotary and gate calls of one tower's forward in
    `models/clip.py`: 6 denses and 2 LayerNorms a block (EVA02: q and k
    rotary in place of their denses, the gate in place of the MLP-in dense,
    and the attention output's LayerNorm); the image tower adds the patch
    dense, `ln_pre` where it has one and `ln_post`, a pooling head 5 denses
    and its LayerNorm; the text tower adds `ln_final`."""
    if tower == "text":
        return 8 * cfg.text_layers + 1
    head = 6 if cfg.pool == "map" else 0
    return (8 + int(cfg.attn_ln)) * cfg.vision_layers + 1 + int(cfg.ln_pre) + 1 + head


@pytest.mark.parametrize("model", ["test-tiny", "test-tiny-siglip", "test-tiny-eva"])
def test_tower_spans_count_fused_and_eager_passes(model, monkeypatch):
    """`fused` and `eager` are the differences of `block_fused`'s counters
    over each tower's queuing: with every dense, LayerNorm, rotary and gate
    pass counted as a launch (as on the card), `fused` is the tower's number
    of them and `eager` 0, `rope` and `glu` the rotary and gate launches
    among them; with each counted as an eager-chain call, the other way round."""
    from clip_retrieval_tpu_torch.ops import block_fused

    m = ClipMapper(enable_image=True, enable_text=True, clip_model=model, batch_size=BS, device="cpu")
    cfg = m.bundle.cfg
    batch = {"image_tensor": np.zeros((2, cfg.image_size, cfg.image_size, 3), np.uint8),
             "text_tokens": m.bundle.tokenize(["a cat"] * 2), "image_filename": ["f"] * 2, "text": ["a cat"] * 2}
    want = {"image": _passes(cfg, "image"), "text": _passes(cfg, "text")}
    for counted, other in (("fused", "eager"), ("eager", "fused")):
        def counting(fn):
            def wrapped(*args, **kwargs):
                if counted == "fused":
                    wrapped.launches += 1
                else:
                    block_fused.record_eager()
                return fn(*args, **kwargs)

            wrapped.launches = fn.launches
            return wrapped

        for name in ("dense_epilogue", "layernorm", "rope_epilogue", "glu_layernorm"):
            monkeypatch.setattr(block_fused, name, counting(getattr(block_fused, name)))
        before = {s["id"] for s in trace.export()}
        m(batch)
        monkeypatch.undo()
        spans = {s["name"]: s for s in trace.export() if s["id"] not in before}
        for tower in ("image", "text"):
            c = spans[f"mapper.{tower}"]["counters"]
            assert c[counted] == want[tower] and c[other] == 0, (tower, c)
            rotary = 2 * cfg.vision_layers if tower == "image" and cfg.rope != "none" else 0
            gates = cfg.vision_layers if tower == "image" and cfg.vision_mlp == "swiglu" else 0
            if counted == "fused":
                assert (c["rope"], c["glu"]) == (rotary, gates), (tower, c)

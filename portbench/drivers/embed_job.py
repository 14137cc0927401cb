"""Driver of the embedding job (`clip-retrieval inference`, input_format
files), as `inference/worker.py` runs it on one card.

Set-up builds the seeded JPEG + caption corpus, makes the weights on the
device and loads them through the port's openai loader into a `ClipMapper`
built once.  Then one call of `inference/runner.py`'s `Runner` runs one
partition with the port's `FilesReader` → `DeviceStagingReader` →
`ClipMapper` → `NumpyWriter` and the stats logger.  The partition's keys
cycle over the corpus's (the reader's sampler picks key i mod the corpus
size for its i-th sample), as many as the window could take at
`window_rate_cap` samples/s, so the reader starts once, as in a job of
1M-sample partitions.  Its first `warm_batches` batches are set-up: they
build and warm every kernel and fill the reader's prefetch, a start that
such a job pays once per million samples.  The window opens when the runner
asks for the next batch, takes no new batch once its seconds have passed,
and closes when the runner has written the last one; the rate is the
window's samples written over that time.

The check draws rows of the window from the written partition, decodes and
tokenizes their corpus files again in the plain reference and holds the
written fp16 image and text embeddings to the reference's float32 ones.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import corpus as corpus_mod  # noqa: E402
from bench import flops, weights  # noqa: E402
from reference import clip_ref, preprocess_ref  # noqa: E402

_CONFIG_KEYS = ("embed_dim", "image_size", "patch_size", "vision_width", "vision_layers", "vision_heads",
                "vision_mlp_ratio", "vocab_size", "context_length", "text_width", "text_layers", "text_heads",
                "text_mlp_ratio", "act", "layernorm_eps")


def program_config(cfg: dict):
    """The port's registered configuration of `cfg`, checked key by key
    against the benchmark's file."""
    from clip_retrieval_tpu_torch.models import configs

    pcfg = configs.get_config(cfg["program_model"])
    for key in _CONFIG_KEYS:
        if key not in cfg:
            continue
        ours, theirs = cfg[key], getattr(pcfg, key)
        theirs = list(theirs) if isinstance(theirs, tuple) else theirs
        if ours != theirs:
            raise ValueError(f"{cfg['name']}: {key} is {ours!r} here and {theirs!r} in the port's "
                             f"{cfg['program_model']!r} configuration")
    return pcfg


class _Window:
    """The staged reader as the runner sees it: after `warm` batches the
    window opens (`on_start` runs) as the runner asks for the next batch,
    and no batch is given once `seconds` have passed since.  The iterator
    left behind is closed by `close()` after the window, so stopping the
    decode threads it feeds is not timed; each batch's hand-out time is
    kept for the run's notes."""

    def __init__(self, warm: int, seconds: float, on_start):
        self.warm, self.seconds, self.on_start = warm, seconds, on_start
        self.reader = self._it = None
        self.t0 = None
        self.asked: list[float] = []  # when the runner asked for each batch
        self.handed: list[float] = []  # when it got it

    def __iter__(self):
        self._it = iter(self.reader)
        while True:
            n = len(self.handed)
            if n == self.warm:
                self.on_start()
                self.t0 = time.perf_counter()
            elif n > self.warm and time.perf_counter() - self.t0 >= self.seconds:
                return
            asked = time.perf_counter()
            batch = next(self._it, None)
            if batch is None:
                return
            self.asked.append(asked)
            self.handed.append(time.perf_counter())
            yield batch

    def close(self):
        if self._it is not None:
            self._it.close()


class Driver:
    def __init__(self, cell, seed: int, device, workdir: str):
        self.cell, self.seed, self.device, self.workdir = cell, seed, device, workdir
        self.cfg, self.traffic = cell.config, cell.traffic
        self.notes: dict = {}

    def setup(self):
        from clip_retrieval_tpu_torch.inference.mapper import ClipMapper
        from clip_retrieval_tpu_torch.models import loaders

        t = self.traffic
        pcfg = program_config(self.cfg)
        self.corpus_dir = os.path.join(self.workdir, "corpus")
        t0 = time.perf_counter()
        self.notes["corpus"] = corpus_mod.build(self.corpus_dir, self.seed, t, self.device)
        self.notes["corpus_s"] = time.perf_counter() - t0
        # the reference remakes the same tensors from the seed after the window
        model = loaders.convert_openai_state_dict(weights.make_state_dict(self.cfg, self.seed + 11, self.device),
                                                  pcfg, self.device).eval()
        self.mapper = ClipMapper(enable_image=True, enable_text=True, clip_model=self.cfg["program_model"],
                                 batch_size=t["batch_size"], compute_dtype=self.cfg["compute_dtype"],
                                 device=self.device)
        self.mapper.bundle.model = model  # the seeded weights replace the zoo's random init, in memory
        self.mapper.model = model

    def window(self, seconds: float, on_start, on_end):
        """One runner call over the partition; `on_start` runs as the window
        opens, after the warm batches, and `on_end` as it closes."""
        from clip_retrieval_tpu_torch.inference.logger import LoggerWriter
        from clip_retrieval_tpu_torch.inference.reader import FilesReader
        from clip_retrieval_tpu_torch.inference.runner import Runner
        from clip_retrieval_tpu_torch.inference.staging import DeviceStagingReader
        from clip_retrieval_tpu_torch.inference.writer import NumpyWriter

        t, mapper, bundle = self.traffic, self.mapper, self.mapper.bundle
        bs, self.warm = t["batch_size"], t["warm_batches"]
        n_keys = bs * (self.warm + math.ceil(seconds * t["window_rate_cap"] / bs))
        self.out = os.path.join(self.workdir, "out")
        win = _Window(self.warm, seconds, on_start)
        mapper_s: list[float] = []

        def timed_mapper(batch):
            t0 = time.perf_counter()
            out = mapper(batch)  # ends in the embeddings' read-back to the host
            mapper_s.append(time.perf_counter() - t0)
            return out

        def reader_builder(_sampler):
            reader = FilesReader(sampler=lambda keys: [keys[i % len(keys)] for i in range(n_keys)],
                                 preprocess=bundle.image_size, tokenizer=lambda texts: bundle.tokenize(texts),
                                 input_dataset=self.corpus_dir, batch_size=bs,
                                 num_prepro_workers=t["num_prepro_workers"], enable_text=True, enable_image=True,
                                 enable_metadata=False)
            win.reader = DeviceStagingReader(reader, mapper)
            return win

        Runner(
            reader_builder=reader_builder,
            mapper_builder=lambda: timed_mapper,
            writer_builder=lambda pid: NumpyWriter(partition_id=pid, output_folder=self.out, enable_text=True,
                                                   enable_image=True, enable_metadata=False,
                                                   output_partition_count=1),
            logger_builder=lambda pid: LoggerWriter(partition_id=pid, stats_folder=self.out + "/stats"),
            output_partition_count=1,
        )(0)
        self.window_s = time.perf_counter() - win.t0
        on_end()
        win.close()
        self.window_batches = len(win.handed) - self.warm
        self.read_s = float(sum(h - a for a, h in zip(win.asked[self.warm:], win.handed[self.warm:])))
        self.mapper_s = float(sum(mapper_s[self.warm:]))
        gaps = np.diff(win.handed)
        ms = [round(1e3 * float(g), 1) for g in gaps]  # each ends at a batch's hand-out
        self.notes.update({"partition_keys": n_keys, "warm_batch_gaps_ms": ms[: self.warm - 1],
                           "batch_gaps_ms": ms[self.warm - 1 :]})
        with open(os.path.join(self.out, "stats", "0.json")) as f:
            self.stats = json.load(f)
        self.rows = int(np.load(os.path.join(self.out, "img_emb", "img_emb_0.npy"), mmap_mode="r").shape[0])
        self.first_row = self.warm * bs  # rows before it are set-up's

    def release(self):
        """Free the program's state before the reference runs."""
        self.mapper = None

    # -- metrics --------------------------------------------------------------

    def attempted(self) -> int:
        """Samples the runner was given in the window."""
        return int(self.stats["sample_count"]) - self.first_row

    def failed(self) -> int:
        return max(0, self.attempted() - (self.rows - self.first_row))

    def end_to_end(self) -> dict:
        return {"embed_samples_per_s": (self.rows - self.first_row) / self.window_s}

    def context(self) -> dict:
        """What the per-layer metric readers read: the runner's waits in
        `next(reader)` and the mapper's calls, each over the window's batches."""
        return {
            "window_s": self.window_s,
            "samples": self.rows - self.first_row,
            "batches": self.window_batches,
            "read_s": self.read_s,
            "inference_s": self.mapper_s,
            "flops_per_sample": flops.image_tower(self.cfg) + flops.text_tower(self.cfg),
        }

    # -- check ----------------------------------------------------------------

    def _sample_rows(self, meta) -> list[int]:
        """Rows of the window drawn from the seed; the longest caption is in."""
        n, a, b = self.traffic["check_rows"], self.first_row, self.rows
        if n >= b - a:  # a sample as large as the window's output is the whole of it
            picks = list(range(a, b))
        else:
            picks = [int(r) for r in np.random.default_rng(self.seed + 5).integers(a, b, n)]
        return picks + [a + int(meta["caption"].iloc[a:].str.len().to_numpy().argmax())]

    def check(self, image_precision: str = "f32", text_precision: str = "f32") -> dict:
        """The numbers compared; the program's written rows against the
        reference.  Another precision puts the reference computed in it in
        the program's place (the control)."""
        import pandas as pd

        n_corpus = self.traffic["samples"]
        meta = pd.read_parquet(os.path.join(self.out, "metadata", "metadata_0.parquet"))
        keys = [corpus_mod.key_of(x) for x in meta["image_path"]]
        img = np.load(os.path.join(self.out, "img_emb", "img_emb_0.npy"), mmap_mode="r")
        txt = np.load(os.path.join(self.out, "text_emb", "text_emb_0.npy"), mmap_mode="r")
        # every sample handed to the mapper written once, in the partition's order
        wrong = int(self.rows - self.first_row != self.attempted())
        wrong += int(keys != [i % n_corpus for i in range(self.rows)]) + int(txt.shape[0] != self.rows)
        images, tokens, got_img, got_txt = [], [], [], []
        size, ctx = self.cfg["image_size"], self.cfg["context_length"]
        for row in self._sample_rows(meta):
            data, caption = corpus_mod.read_sample(self.corpus_dir, keys[row])
            wrong += int(meta["caption"].iloc[row] != caption)
            images.append(preprocess_ref.decode_resize_crop(data, size))
            tokens.append(preprocess_ref.tokenize(caption, ctx))
            got_img.append(img[row])
            got_txt.append(txt[row])
        sd = weights.make_state_dict(self.cfg, self.seed + 11, self.device)
        ref_img, ref_txt = self._reference(sd, np.stack(images), np.stack(tokens), "f32", "f32")
        if image_precision != "f32" or text_precision != "f32":
            got_img, got_txt = self._reference(sd, np.stack(images), np.stack(tokens), image_precision,
                                               text_precision)
        img_gap = _max_cos_gap(np.asarray(got_img, np.float32), ref_img)
        txt_gap = _max_cos_gap(np.asarray(got_txt, np.float32), ref_txt)
        return {"img_gap": img_gap, "txt_gap": txt_gap, "rows_wrong": int(wrong)}

    def _reference(self, sd: dict, images: np.ndarray, tokens: np.ndarray, img_prec: str, txt_prec: str):
        import torch

        out_i, out_t = [], []
        block = self.traffic["check_block"]
        with torch.inference_mode():
            for a in range(0, images.shape[0], block):
                im = torch.from_numpy(images[a : a + block]).to(self.device)
                tk = torch.from_numpy(tokens[a : a + block]).to(self.device)
                out_i.append(clip_ref.encode_image(sd, self.cfg, im, img_prec).cpu().numpy())
                out_t.append(clip_ref.encode_text(sd, self.cfg, tk, txt_prec).cpu().numpy())
        return np.concatenate(out_i), np.concatenate(out_t)


def _max_cos_gap(got: np.ndarray, ref: np.ndarray) -> float:
    g = got.astype(np.float64)
    r = ref.astype(np.float64)
    cos = (g * r).sum(1) / (np.linalg.norm(g, axis=1) * np.linalg.norm(r, axis=1))
    return float(np.max(1.0 - cos))

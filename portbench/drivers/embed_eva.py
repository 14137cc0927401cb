"""Driver of the embedding job at EVA02-CLIP-L/14-336 (`clip-retrieval
inference`, input_format files, `clip_model="EVA02-L-14-336"`), as
`inference/worker.py` runs it on one card.

It is the embedding job's driver (`drivers/embed_job.py`, whose window it
runs unchanged) with EVA02's pieces in place of CLIP's:

- set-up resolves the port's configuration before anything else, so that a
  program without it fails within seconds; then it builds the corpus, makes
  the seeded weights in open_clip's EVA02 layout (`bench/eva_weights.py`)
  and loads them through the port's `loaders.convert_eva_state_dict`;
- the model FLOPs per sample are EVA02's (`bench/eva_flops.py`);
- the check decodes and tokenizes the window's sampled rows again in the
  plain EVA02 reference (`reference/eva_ref.py`: the shorter-side resize and
  centre crop, CLIP's byte-level tokens) and holds the written fp16 rows to
  its float32 ones.

The corpus's images are 384 px squares, so the window's reader resizes them
to 336 on its crop path, as open_clip's preprocessing does.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import corpus as corpus_mod  # noqa: E402
from bench import eva_flops, eva_weights, spec  # noqa: E402
from reference import eva_ref  # noqa: E402

embed_job = spec.driver("embed_job")

# the configuration file's keys beyond CLIP's, each held to the port's configuration
_EVA_KEYS = ("text_layernorm_eps", "class_token", "ln_pre", "patch_bias", "pool", "text_causal", "text_pool",
             "text_proj_bias", "image_mean", "image_std", "resize", "tokenizer", "rope", "rope_grid", "vision_mlp",
             "attn_ln", "vision_proj_bias")


def program_config(cfg: dict):
    """The port's configuration of `cfg`, checked key by key; raises at once
    when the port has none of that name."""
    pcfg = embed_job.program_config(cfg)
    for key in _EVA_KEYS:
        ours, theirs = cfg[key], getattr(pcfg, key)
        theirs = list(theirs) if isinstance(theirs, tuple) else theirs
        if ours != theirs:
            raise ValueError(f"{cfg['name']}: {key} is {ours!r} here and {theirs!r} in the port's configuration")
    for tower in ("vision", "text"):
        mlp = int(round(cfg[f"{tower}_width"] * cfg[f"{tower}_mlp_ratio"]))
        if mlp != cfg[f"{tower}_mlp_dim"]:
            raise ValueError(f"{cfg['name']}: {tower}_mlp_ratio gives {mlp}, not {tower}_mlp_dim")
    return pcfg


class Driver(embed_job.Driver):
    def setup(self):
        pcfg = program_config(self.cfg)
        from clip_retrieval_tpu_torch.inference.mapper import ClipMapper
        from clip_retrieval_tpu_torch.models import loaders

        t = self.traffic
        self.corpus_dir = os.path.join(self.workdir, "corpus")
        t0 = time.perf_counter()
        self.notes["corpus"] = corpus_mod.build(self.corpus_dir, self.seed, t, self.device)
        self.notes["corpus_s"] = time.perf_counter() - t0
        # the reference remakes the same tensors from the seed after the window
        sd = eva_weights.make_state_dict(self.cfg, self.seed + 11, self.device)
        model = loaders.convert_eva_state_dict(sd, pcfg, self.device).eval()
        del sd
        self.mapper = ClipMapper(enable_image=True, enable_text=True, clip_model=self.cfg["program_model"],
                                 batch_size=t["batch_size"], compute_dtype=self.cfg["compute_dtype"],
                                 device=self.device)
        self.mapper.bundle.model = model  # the seeded weights replace the zoo's random init, in memory
        self.mapper.model = model

    def context(self) -> dict:
        ctx = super().context()
        ctx["flops_per_sample"] = eva_flops.image_tower(self.cfg) + eva_flops.text_tower(self.cfg)
        return ctx

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
            images.append(eva_ref.preprocess(data, size))
            tokens.append(eva_ref.tokenize(caption, ctx))
            got_img.append(img[row])
            got_txt.append(txt[row])
        sd = eva_weights.make_state_dict(self.cfg, self.seed + 11, self.device)
        images, tokens = np.stack(images), np.stack(tokens)
        ref_img, ref_txt = self._reference(sd, images, tokens, "f32", "f32")
        if image_precision != "f32" or text_precision != "f32":
            got_img, got_txt = self._reference(sd, images, tokens, image_precision, text_precision)
        img_gap = embed_job._max_cos_gap(np.asarray(got_img, np.float32), ref_img)
        txt_gap = embed_job._max_cos_gap(np.asarray(got_txt, np.float32), ref_txt)
        return {"img_gap": img_gap, "txt_gap": txt_gap, "rows_wrong": int(wrong)}

    def _reference(self, sd: dict, images: np.ndarray, tokens: np.ndarray, img_prec: str, txt_prec: str):
        import torch

        out_i, out_t = [], []
        block = self.traffic["check_block"]
        with torch.inference_mode():
            for a in range(0, images.shape[0], block):
                im = torch.from_numpy(images[a : a + block]).to(self.device)
                tk = torch.from_numpy(tokens[a : a + block]).to(self.device)
                out_i.append(eva_ref.encode_image(sd, self.cfg, im, img_prec).cpu().numpy())
                out_t.append(eva_ref.encode_text(sd, self.cfg, tk, txt_prec).cpu().numpy())
        return np.concatenate(out_i), np.concatenate(out_t)

"""Model zoo: resolve a `clip_model` string to (config, model, tokenizer).

Counterpart of `clip_retrieval_tpu/models/zoo.py`, with the same offline
sources:

- a registered config name ("ViT-L/14", "test-tiny", ...) → random weights
  from `init_clip(cfg, seed=0)` (the same seed gives other numbers than the
  JAX package's init);
- "<config>:<checkpoint path>" → an openai/open_clip/HF state dict or our
  .npz from disk;
- "hf:<local dir>" → transformers CLIPModel.from_pretrained(dir).

The model is built on `device`.  Tokenizer: real CLIP BPE when a merges file
is available (CRT_BPE_PATH or cache), else the byte-level fallback; a SigLIP
config takes SigLIP's framing over byte-level ids (`SiglipTokenizer`).  The
bundle's `preprocess` is the config's host resize (centre crop or squash).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import configs, loaders
from .clip import CLIP, init_clip
from ..utils.device import resolve_device
from .preprocess import decode_resize_center_crop, decode_resize_squash
from .tokenizer import CLIPTokenizer, SiglipTokenizer, default_bpe_path


@dataclasses.dataclass
class ModelBundle:
    name: str
    cfg: configs.CLIPConfig
    model: CLIP
    tokenizer: CLIPTokenizer | SiglipTokenizer

    @property
    def image_size(self) -> int:
        return self.cfg.image_size

    @property
    def preprocess(self):
        """Image bytes → (image_size, image_size, 3) uint8, resized as the
        config says; the readers' `preprocess`."""
        resize = {"crop": decode_resize_center_crop, "squash": decode_resize_squash}[self.cfg.resize]
        return functools.partial(resize, size=self.cfg.image_size)

    def tokenize(self, texts, context_length: int | None = None) -> np.ndarray:
        return self.tokenizer(texts, context_length or self.cfg.context_length)


def _make_tokenizer(cfg: configs.CLIPConfig, real_weights: bool = False) -> CLIPTokenizer | SiglipTokenizer:
    if cfg.tokenizer == "siglip":
        if real_weights:
            print("WARNING: SigLIP's SentencePiece model is not available; captions are tokenized as bytes, "
                  "which a trained text tower reads as other tokens (text embeddings will be meaningless)")
        return SiglipTokenizer()
    if default_bpe_path() is not None:
        return CLIPTokenizer()
    if real_weights:
        # byte-fallback ids index arbitrary rows of a trained token embedding
        raise ValueError(
            "no CLIP BPE merges file found but a real checkpoint was loaded; text tokenized with the "
            "byte-fallback would embed as garbage — set CRT_BPE_PATH to the CLIP merges file "
            "(bpe_simple_vocab_16e6.txt.gz)"
        )
    tok = CLIPTokenizer.byte_fallback()
    if tok.vocab_size > cfg.vocab_size:
        raise ValueError(
            f"no BPE vocab file available and byte-fallback vocab ({tok.vocab_size}) exceeds model vocab "
            f"({cfg.vocab_size}); set CRT_BPE_PATH to the CLIP merges file"
        )
    return tok


def load_model(
    clip_model: str, checkpoint: str | None = None, device: str | torch.device = "cuda"
) -> ModelBundle:
    """Resolve clip_model (see module docstring) to a ModelBundle on `device`.

    `"open_clip:ARCH/PRETRAINED"` resolves ARCH as a config name (hosted
    weights cannot be fetched: pass `checkpoint=`), and `"hf_clip:DIR"` is
    an alias of `"hf:DIR"`.  Raises for device="cuda" when no GPU is visible."""
    device = resolve_device(device)
    if clip_model.startswith("nm:"):
        raise ValueError(
            "deepsparse ('nm:') clip_model backends are sparse-ONNX CPU accelerators this package does "
            "not run; use a config name (ViT-*), '<config>:<checkpoint>', or 'hf:<dir>'"
        )
    if clip_model.startswith("open_clip:"):
        arch = clip_model[len("open_clip:") :]
        if ":" in arch and checkpoint is None:  # "ARCH:/local/ckpt.pt"
            arch, checkpoint = arch.split(":", 1)
        if "/" in arch:
            arch, pretrained = arch.split("/", 1)
            if checkpoint is None:
                print(
                    f"WARNING: open_clip pretrained tag {pretrained!r} names a hosted weight set; weights "
                    "load only from local files — pass checkpoint=/path/to/state_dict"
                )
        clip_model = arch
    if clip_model.startswith("hf_clip:"):
        clip_model = "hf:" + clip_model[len("hf_clip:") :]
    if clip_model.startswith("hf:"):
        import transformers

        hf = transformers.CLIPModel.from_pretrained(clip_model[3:])
        cfg = loaders.config_from_hf(hf.config)
        model = loaders.convert_hf_state_dict(hf.state_dict(), cfg, device)
        return ModelBundle(clip_model, cfg, model, _make_tokenizer(cfg, real_weights=True))

    if ":" in clip_model and checkpoint is None:
        clip_model, checkpoint = clip_model.split(":", 1)

    cfg = configs.get_config(clip_model)
    if checkpoint:
        model, cfg = loaders.load_checkpoint(checkpoint, cfg, device)
    else:
        if cfg.name != "test-tiny":
            print(f"WARNING: no checkpoint for {clip_model}; using random weights (embeddings will be meaningless)")
        model = init_clip(cfg, 0, device)
    return ModelBundle(clip_model, cfg, model, _make_tokenizer(cfg, real_weights=checkpoint is not None))

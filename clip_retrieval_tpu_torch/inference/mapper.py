"""Mapper: batches → L2-normalized fp16 embeddings on one device.

Counterpart of `clip_retrieval_tpu/inference/mapper.py`.  Input batch dict
with "image_tensor" (uint8 HWC) / "text_tokens" → output dict with
"image_embs" / "text_embs" as L2-normalized **fp16 numpy**, passing
"image_filename" / "text" / "metadata" through.

- One process owns one explicit device.  The default is "cuda", and the
  mapper raises when no GPU is visible: only an explicit device="cpu" runs on
  the CPU.
- compute_dtype="auto" is bfloat16 on CUDA and float32 on the CPU; weights
  stay f32 on the device and are cast per matmul (see `models/clip.py`).
- Batches are padded to the fixed batch size, as in the JAX package, so the
  device always sees one shape.
- Only uint8 pixels and int tokens cross to the device, only fp16
  embeddings come back.  Batches staged by `staging.DeviceStagingReader`
  are already padded and on the device.
- With `use_mclip`, the text embeddings come from the M-CLIP encoder in
  `mclip_model` (`models/mclip.py`), on the same device, from the raw
  captions; the images still go through the CLIP tower.
- Each call records two spans (`utils/trace.py`): `mapper.enqueue`, from
  the call's start until both towers are queued on the device, with the
  thread's CPU ns in it (`cpu_ns`: below its wall time, the thread waited
  for the interpreter lock or a core), and `mapper.readback`, the
  embeddings' read-back to the host.  Inside `mapper.enqueue`,
  `mapper.image` and `mapper.text` time the queuing of each CLIP tower,
  with the counter `tokens`: the rows the tower runs × its sequence length,
  and the counters `fused` (launches of `ops/block_fused.py`'s kernels
  while the tower was queued), `eager` (its dense, LayerNorm, rotary and
  gate calls that took the eager chain instead), `rope` and `glu`, the
  launches of the rotary epilogue and of the SwiGLU gate among `fused`,
  and `gemm` and `split`, its dense calls that took the one-kernel GEMM
  (`block_fused.dense_gemm`, also among `fused`) and those that took the
  f32 product and the epilogue's pass (`block_fused.dense_epilogue`).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..models import clip as tclip
from ..models import zoo
from ..ops import block_fused, cuda_build
from ..utils import trace
from ..utils.device import resolve_device
from .staging import STAGED_KEY

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


_COUNTERS = ("fused", "eager", "rope", "glu", "gemm", "split")


def _counts() -> tuple[int, ...]:
    """The `_COUNTERS` so far: fused launches, eager calls, rotary launches,
    gate launches, one-kernel GEMM launches, split-route epilogue launches."""
    return (*block_fused.counts(), block_fused.rope_epilogue.launches, block_fused.glu_layernorm.launches,
            block_fused.dense_gemm.launches, block_fused.dense_epilogue.launches)


def _fused_counts(before: tuple[int, ...]) -> dict[str, int]:
    """The tower's counters since `before` (`_counts()`)."""
    return {key: now - then for key, now, then in zip(_COUNTERS, _counts(), before)}


class ClipMapper:
    """Callable mapping reader batches to embedding dicts."""

    def __init__(
        self,
        enable_image: bool,
        enable_text: bool,
        clip_model: str = "ViT-B/32",
        use_mclip: bool = False,
        mclip_model: str = "",
        checkpoint: str | None = None,
        batch_size: int = 256,
        compute_dtype: str = "auto",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the towers' kernels (K1, the block's fused passes), built side by side on a checkout's first run
            cuda_build.build_all(tclip.KERNEL_LIBRARIES)
        self.mclip = None
        if use_mclip:
            # the reference mapper swaps the text path for a multilingual
            # encoder; it reads raw text, not CLIP tokens
            from ..models.mclip import load_mclip

            self.mclip = load_mclip(mclip_model, self.device)
        self.enable_image = enable_image
        self.enable_text = enable_text
        self.batch_size = batch_size
        self.bundle = zoo.load_model(clip_model, checkpoint, self.device)
        self.model = self.bundle.model.eval()
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be 'auto', 'bfloat16' or 'float32', got {compute_dtype!r}")
        self.compute_dtype = _DTYPES[compute_dtype]

    # -- helpers ----------------------------------------------------------

    def pad_batch(self, arr: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad the leading dim to the fixed batch size."""
        n = arr.shape[0]
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n, *arr.shape[1:]), dtype=arr.dtype)
            arr = np.concatenate([arr, pad])
        return arr, n

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def embed_images(self, images: torch.Tensor) -> torch.Tensor:
        """Padded device uint8 (B, H, W, 3) → fp16 (B, embed_dim) on device."""
        with torch.inference_mode():
            return tclip.encode_image(self.model, images, compute_dtype=self.compute_dtype).half()

    def embed_texts(self, tokens: torch.Tensor) -> torch.Tensor:
        """Padded device int (B, context_length) → fp16 (B, embed_dim)."""
        with torch.inference_mode():
            return tclip.encode_text(self.model, tokens, compute_dtype=self.compute_dtype).half()

    # -- main entry -------------------------------------------------------

    def __call__(self, batch: dict[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        staged_n = batch.get(STAGED_KEY)
        img = txt = None
        # queue both towers on the device before reading either back
        with trace.span("mapper.enqueue") as enqueue:
            cpu_ns = time.thread_time_ns()
            if self.enable_image:
                images = batch["image_tensor"]
                with trace.span("mapper.image") as tower:
                    before = _counts()
                    if staged_n is None:
                        images, n = self.pad_batch(images)
                        images = self.to_device(images)
                    else:
                        n = staged_n
                    img = self.embed_images(images)[:n]
                    tower.count(tokens=images.shape[0] * self.model.cfg.vision_seq_len, **_fused_counts(before))
            if self.enable_text and self.mclip is not None:
                out["text_embs"] = self.mclip(batch["text"])
                out["text"] = batch["text"]
            elif self.enable_text:
                tokens = batch["text_tokens"]
                with trace.span("mapper.text") as tower:
                    before = _counts()
                    if staged_n is None:
                        tokens, n = self.pad_batch(tokens.astype(np.int32))
                        tokens = self.to_device(tokens)
                    else:
                        n = staged_n
                    txt = self.embed_texts(tokens)[:n]
                    tower.count(tokens=tokens.shape[0] * tokens.shape[1], **_fused_counts(before))
            enqueue.count(cpu_ns=time.thread_time_ns() - cpu_ns)
        with trace.span("mapper.readback"):
            if img is not None:
                out["image_embs"] = img.cpu().numpy()
            if txt is not None:
                out["text_embs"] = txt.cpu().numpy()
        if img is not None:
            out["image_filename"] = batch["image_filename"]
        if txt is not None:
            out["text"] = batch["text"]
        if "metadata" in batch:
            out["metadata"] = batch["metadata"]
        return out

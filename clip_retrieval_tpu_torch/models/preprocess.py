"""Host image preprocessing: decode, bicubic resize, center crop → uint8 HWC
(CLIP), or decode and a bicubic resize of both sides (SigLIP's "squash"),
and the batched bicubic resize on the device.

Counterpart of `clip_retrieval_tpu/models/preprocess.py`.  The host side
drives the port's copy of the C++ decoder (`native/image_decode.cpp`), with
PIL as the fallback for what that decoder rejects or where it
cannot be built.  Normalization happens on the device inside
`clip.encode_image`, so only uint8 pixels cross to the GPU.
"""

from __future__ import annotations

import io
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..native import get_decode_lib
from ..utils.device import resolve_device

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


def _native_decode(data: bytes, size: int, fast: bool) -> np.ndarray | None:
    """C++ decode+resize+crop; None → PIL path (unsupported container,
    exotic colour space, decode error, or no decoder library)."""
    lib = get_decode_lib()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    if lib.crt_decode_resize_crop(data, len(data), size, int(fast), out) == 0:
        return out
    return None


def decode_resize_center_crop(data, size: int, *, fast: bool = False) -> np.ndarray:
    """bytes/PIL image → (size, size, 3) uint8, CLIP-style bicubic + crop
    (torchvision Resize(size, BICUBIC) + CenterCrop(size) + RGB).
    `fast=True` (or CRT_FAST_DECODE=1) lets libjpeg scale the DCT."""
    fast = fast or os.environ.get("CRT_FAST_DECODE") == "1"
    if isinstance(data, (bytes, bytearray, memoryview)):
        out = _native_decode(bytes(data), size, fast)
        if out is not None:
            return out
    return _pil_decode_resize_crop(data, size)


def _pil_decode_resize_crop(data, size: int) -> np.ndarray:
    if not _HAS_PIL:
        raise RuntimeError("PIL required for host image decode where the native decoder cannot decode")
    img = data if isinstance(data, Image.Image) else Image.open(io.BytesIO(data))
    img = img.convert("RGB")
    w, h = img.size
    if w < h:  # shorter side → size
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nh, nw = size, max(size, int(round(w * size / h)))
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, dtype=np.uint8)


def decode_resize_squash(data, size: int) -> np.ndarray:
    """bytes/PIL image → (size, size, 3) uint8: both sides resized to `size`,
    bicubic, no crop (SigLIP's preprocessing; PIL's resize, as open_clip's
    torchvision `Resize((size, size))` on a PIL image does)."""
    if not _HAS_PIL:
        raise RuntimeError("PIL required for the squash resize")
    img = data if isinstance(data, Image.Image) else Image.open(io.BytesIO(data))
    img = img.convert("RGB").resize((size, size), Image.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


def decode_batch(items: Sequence[bytes], size: int, *, fast: bool = False) -> tuple[np.ndarray, list[int]]:
    """Decode a batch; corrupt images are skipped.  Returns (stacked uint8
    array, kept indices).  One native OpenMP call for the whole batch where
    the decoder library exists; items it rejects go to PIL."""
    fast = fast or os.environ.get("CRT_FAST_DECODE") == "1"
    lib = get_decode_lib()
    rows, kept = [], []
    if lib is not None and items:
        blob = b"".join(bytes(d) for d in items)
        offsets = np.zeros(len(items) + 1, np.int64)
        np.cumsum([len(d) for d in items], out=offsets[1:])
        out = np.empty((len(items), size, size, 3), np.uint8)
        ok = np.empty(len(items), np.int32)
        lib.crt_decode_batch(np.frombuffer(blob, np.uint8), offsets, len(items), size, int(fast), out, ok)
        for i, code in enumerate(ok):
            try:
                # straight to PIL for rejected items: the native decoder would fail again
                rows.append(out[i] if code == 0 else _pil_decode_resize_crop(items[i], size))
                kept.append(i)
            except Exception:
                continue
    else:
        for i, data in enumerate(items):
            try:
                rows.append(decode_resize_center_crop(data, size, fast=fast))
                kept.append(i)
            except Exception:
                continue
    if not rows:
        return np.zeros((0, size, size, 3), np.uint8), []
    return np.stack(rows), kept


def resize_on_device(images, size: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """Batched bicubic resize: (B, H, W, 3) uint8 or float → (B, size, size,
    3) float32, uint8 divided by 255 (not clamped).  A tensor stays where it
    lies; a numpy array goes to `device`.

    Computes what `jax.image.resize(x, (B, size, size, 3), "bicubic")`
    does: the Keys kernel at a = -0.5, widened by the scale when
    downsampling, with the weights renormalised at the borders.  That is
    `F.interpolate`'s antialiased bicubic; without `antialias=True` it takes
    a = -0.75 and clamps indices instead."""
    x = images
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
    y = x.float()
    if x.dtype == torch.uint8:
        y = y / 255.0
    y = F.interpolate(y.permute(0, 3, 1, 2), size=(size, size), mode="bicubic", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()

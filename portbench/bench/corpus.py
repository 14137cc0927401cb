"""A seeded JPEG + caption corpus in the layout img2dataset writes by default
(`<shard>/<key>.jpg` beside `<key>.txt`, images resized to 256 px, JPEG
quality 95), built in set-up under a directory the caller owns.

Images are natural-like: a sum of bicubically upsampled random fields whose
amplitude falls with frequency (about 1/f, as in photographs), with a
per-image colour balance and a fine texture whose strength is one of a
fixed set of levels.  White noise would make JPEGs several times larger
than a photograph's and decode far slower.  Every seed gets the same
multiset of texture levels and caption lengths in another order, so JPEG
sizes, decode cost and token counts do not change with the seed.  Pixels
are made on the device in blocks; JPEG encoding runs on a thread pool.
"""

from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import captions as cap

_BLOCK = 512


def _pixels(gen, n: int, size: int, octaves: list[int], texture, device):
    """(n, size, size, 3) uint8 images on the host."""
    import torch
    import torch.nn.functional as F

    f = torch.zeros(n, 3, size, size, device=device)
    for g in octaves:
        small = torch.randn(n, 3, g, g, generator=gen, device=device)
        f += F.interpolate(small, size=(size, size), mode="bicubic", align_corners=False) / g
    f = f / f.std(dim=(1, 2, 3), keepdim=True).clamp(min=1e-6)
    mix = 0.5 + 0.5 * torch.rand(n, 3, 3, generator=gen, device=device)  # channels share structure
    mix = mix / mix.sum(dim=1, keepdim=True)
    f = torch.einsum("nchw,ncd->ndhw", f, mix)
    f = f / f.std(dim=(1, 2, 3), keepdim=True).clamp(min=1e-6)
    amp = 35 + 25 * torch.rand(n, 1, 1, 1, generator=gen, device=device)
    base = 80 + 90 * torch.rand(n, 3, 1, 1, generator=gen, device=device)
    grain = torch.randn(n, 1, size, size, generator=gen, device=device)
    f = f * amp + base + texture.view(n, 1, 1, 1) * grain
    return f.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()


def _encode(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def build(folder: str, seed: int, traffic: dict, device, workers: int = 8) -> dict:
    """Write the corpus; returns {"samples": n, "mean_jpeg_bytes": ...}."""
    import torch

    n = traffic["samples"]
    img = traffic["image"]
    levels = np.asarray(img["texture_levels"], np.float32)
    texture = levels[np.arange(n) % len(levels)][np.random.default_rng(seed + 1).permutation(n)]
    c = traffic["caption_words"]
    counts = cap.lengths(seed + 2, n, c["median"], c["sigma"], c["min"], c["max"])
    texts = cap.captions(seed + 3, np.arange(n), counts)
    shard = os.path.join(folder, "00000")
    os.makedirs(shard, exist_ok=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def write(i: int, data: bytes) -> int:
        with open(os.path.join(shard, f"{i:09d}.jpg"), "wb") as f:
            f.write(data)
        with open(os.path.join(shard, f"{i:09d}.txt"), "w") as f:
            f.write(texts[i])
        return len(data)

    sizes: list[int] = []
    with ThreadPoolExecutor(workers) as pool:
        for a in range(0, n, _BLOCK):
            b = min(a + _BLOCK, n)
            tex = torch.from_numpy(texture[a:b]).to(device)
            arrs = _pixels(gen, b - a, img["size"], img["octaves"], tex, device)
            datas = list(pool.map(_encode, arrs))
            sizes += list(pool.map(write, range(a, b), datas))
    return {"samples": n, "mean_jpeg_bytes": float(np.mean(sizes))}


def key_of(path: str) -> int:
    """Sample index of a corpus file path (`.../000000123.jpg` → 123)."""
    return int(os.path.basename(str(path)).split(".", 1)[0])


def read_sample(folder: str, i: int) -> tuple[bytes, str]:
    base = os.path.join(folder, "00000", f"{i:09d}")
    with open(base + ".jpg", "rb") as f:
        data = f.read()
    with open(base + ".txt") as f:
        return data, f.read()

"""Plain image preprocessing and tokenization, after openai CLIP's
`_transform` (shorter side to the model's size, bicubic, center crop) and
its tokenizer run without a merges file (byte-level tokens: each UTF-8 byte
of a word is a token, the word's last byte carries `</w>`).

The benchmark's captions are lowercase ASCII words separated by single
spaces, so the byte-level tokens are plain arithmetic on the characters."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image

# openai's bytes_to_unicode lists the printable bytes 33..126 first, so an
# ASCII letter b has vocabulary index b - 33, and its `</w>` form 256 + b - 33
_SOT, _EOT = 512, 513


def decode_resize_crop(data: bytes, size: int) -> np.ndarray:
    img = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = img.size
    if w < h:
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nh, nw = size, max(size, int(round(w * size / h)))
    img = img.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    return np.asarray(img.crop((left, top, left + size, top + size)), dtype=np.uint8)


def tokenize(caption: str, context: int) -> np.ndarray:
    if not all(c == " " or "a" <= c <= "z" for c in caption):
        raise ValueError(f"the reference tokenizes lowercase ASCII words only: {caption!r}")
    ids = [_SOT]
    for word in caption.split():
        codes = [ord(c) - 33 for c in word]
        codes[-1] += 256
        ids += codes
    ids.append(_EOT)
    if len(ids) > context:
        ids = ids[:context]
        ids[-1] = _EOT
    out = np.zeros(context, np.int32)
    out[: len(ids)] = ids
    return out

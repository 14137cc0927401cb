"""Plain SigLIP So400m forward over a `transformers.SiglipModel`-layout state
dict, after the published model (Zhai et al. 2023, arXiv:2303.15343;
transformers' `modeling_siglip`), in float32, one image or caption batch at
a time, with no kernel and no cache.  It imports neither the JAX package nor
its PyTorch port.

- Image: a bicubic resize of both sides to the model's size (no crop),
  x/255, mean and std 0.5; a stride-P "valid" convolution with bias (the
  pixels past the last whole patch are dropped), learned positions, no class
  token and no pre-norm; pre-LN blocks (q/k/v/out with bias, scale dh^-1/2,
  no mask; fc1 → tanh GELU → fc2); `post_layernorm` over every token; the
  attention-pooling head: a learned probe is the one query over the tokens
  (q|k|v stacked in `in_proj`, then `out_proj`), then h + MLP(LN(h)),
  the feature is its row; no projection.
- Text: bidirectional blocks with no attention mask, padding included;
  `final_layer_norm`; the last position pooled through `head`, a Linear
  with bias.
- Tokens: no start token, EOS id 1 appended, padded with id 1 to the
  context, an over-long caption cut with EOS kept last.

Departures from the published model: the SentencePiece vocabulary is not in
the repository, so UTF-8 byte b is token 3 + b; the weights are random from
a seed, not the released checkpoint's.

`precision` picks the arithmetic of every matrix product and convolution:
- "f32": float32, TF32 off (the reference);
- "fp8": each product's operands rounded to float8 e4m3 with a per-tensor
  scale, accumulated in float32 (the control of a bfloat16 path).
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

MEAN = STD = (0.5, 0.5, 0.5)
EOS = PAD = 1
BYTE_OFFSET = 3
FP8_MAX = 448.0


def preprocess(data: bytes, size: int) -> np.ndarray:
    """Image bytes → (size, size, 3) uint8, bicubic, both sides to `size`."""
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img.resize((size, size), Image.BICUBIC), dtype=np.uint8)


def tokenize(caption: str, context: int) -> np.ndarray:
    ids = [BYTE_OFFSET + b for b in caption.encode("utf-8")][: context - 1] + [EOS]
    out = np.full(context, PAD, np.int32)
    out[: len(ids)] = ids
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision!r}")
        self.fp8 = precision == "fp8"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def ops(self, *xs):
        return tuple(_fp8(x) if self.fp8 else x for x in xs)

    def linear(self, x, w, b=None):
        """x @ w.T + b with w as torch stores a Linear's weight (out, in)."""
        x, w = self.ops(x, w)
        y = x @ w.T
        return y if b is None else y + b

    def conv(self, x, w, b, stride):
        x, w = self.ops(x, w)
        return F.conv2d(x, w, b, stride=stride)


def _layer_norm(x, sd, p, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], eps)


def _attend(a: Arith, q, k, v, heads):
    """softmax(q·kᵀ·dh^-1/2)·v per head, no mask; q (B, Sq, W), k v (B, S, W)."""
    b, sq, w = q.shape
    split = lambda t: t.reshape(b, t.shape[1], heads, w // heads).transpose(1, 2)  # noqa: E731
    q, k, v = split(q), split(k), split(v)
    q, k = a.ops(q, k)
    p_attn, v = a.ops(((q @ k.transpose(-1, -2)) * (w // heads) ** -0.5).softmax(dim=-1), v)
    return (p_attn @ v).transpose(1, 2).reshape(b, sq, w)


def _mlp(a: Arith, x, sd, p):
    h = a.linear(x, sd[p + ".fc1.weight"], sd[p + ".fc1.bias"])
    return a.linear(F.gelu(h, approximate="tanh"), sd[p + ".fc2.weight"], sd[p + ".fc2.bias"])


def _encoder(a: Arith, x, sd, prefix, layers, heads, eps):
    for i in range(layers):
        p = f"{prefix}.encoder.layers.{i}"
        h = _layer_norm(x, sd, p + ".layer_norm1", eps)
        q, k, v = (a.linear(h, sd[f"{p}.self_attn.{n}_proj.weight"], sd[f"{p}.self_attn.{n}_proj.bias"])
                   for n in ("q", "k", "v"))
        o = _attend(a, q, k, v, heads)
        x = x + a.linear(o, sd[p + ".self_attn.out_proj.weight"], sd[p + ".self_attn.out_proj.bias"])
        x = x + _mlp(a, _layer_norm(x, sd, p + ".layer_norm2", eps), sd, p + ".mlp")
    return x


def normalize_pixels(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) → float32 (B, 3, H, W), mean and std 0.5."""
    x = images_u8.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def image_features(a: Arith, x: torch.Tensor, sd: dict, cfg: dict) -> torch.Tensor:
    """Normalized pixels (B, 3, H, W) → unnormalized (B, W) features."""
    e = "vision_model.embeddings."
    x = a.conv(x, sd[e + "patch_embedding.weight"], sd[e + "patch_embedding.bias"], cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2) + sd[e + "position_embedding.weight"]
    eps, heads = cfg["layernorm_eps"], cfg["vision_heads"]
    x = _encoder(a, x, sd, "vision_model", cfg["vision_layers"], heads, eps)
    x = _layer_norm(x, sd, "vision_model.post_layernorm", eps)
    h = "vision_model.head."
    probe = sd[h + "probe"].expand(x.shape[0], 1, -1)
    wq, wk, wv = sd[h + "attention.in_proj_weight"].chunk(3)
    bq, bk, bv = sd[h + "attention.in_proj_bias"].chunk(3)
    o = _attend(a, a.linear(probe, wq, bq), a.linear(x, wk, bk), a.linear(x, wv, bv), heads)
    o = a.linear(o, sd[h + "attention.out_proj.weight"], sd[h + "attention.out_proj.bias"])
    o = o + _mlp(a, _layer_norm(o, sd, h + "layernorm", eps), sd, h + "mlp")
    return o[:, 0]


def text_features(a: Arith, tokens: torch.Tensor, sd: dict, cfg: dict) -> torch.Tensor:
    """int (B, context) ids → unnormalized (B, embed) features."""
    e = "text_model.embeddings."
    tokens = tokens.long()
    x = sd[e + "token_embedding.weight"][tokens] + sd[e + "position_embedding.weight"][: tokens.shape[1]]
    eps = cfg["layernorm_eps"]
    x = _encoder(a, x, sd, "text_model", cfg["text_layers"], cfg["text_heads"], eps)
    x = _layer_norm(x, sd, "text_model.final_layer_norm", eps)
    return a.linear(x[:, -1], sd["text_model.head.weight"], sd["text_model.head.bias"])


def encode_image(sd: dict, cfg: dict, images_u8: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """uint8 (B, H, W, 3) preprocessed images → L2-normalized float32 (B, embed)."""
    a = Arith(precision)
    return F.normalize(image_features(a, normalize_pixels(images_u8), sd, cfg), dim=-1)


def encode_text(sd: dict, cfg: dict, tokens: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """int (B, context) token ids → L2-normalized float32 (B, embed)."""
    a = Arith(precision)
    return F.normalize(text_features(a, tokens, sd, cfg), dim=-1)

"""Plain EVA02-CLIP-L/14 forward over an open_clip `EVA02-L-14-336` state
dict, after the published model (EVA-CLIP, arXiv:2303.15389; EVA-02,
arXiv:2303.11331; timm's `Eva` trunk as open_clip wraps it, and open_clip's
text transformer), in float32, one image or caption batch at a time, with no
kernel and no cache.  It imports neither the JAX package nor its PyTorch
port.

- Image: the shorter side resized to the model's size (bicubic) and centre
  cropped, x/255, CLIP's mean and std; a stride-P convolution with bias, the
  class token, learned positions, no pre-norm; pre-LN blocks: q, k, v
  (q and v biased, k not), q and k of the patch rows turned by 2-D rotary
  angles, softmax(q·kᵀ·dh^-1/2)·v with no mask, a LayerNorm on the attention
  output before its projection; SwiGLU: silu(fc1_g(x)) ⊙ fc1_x(x), a
  LayerNorm on that hidden, then fc2; the final norm, the class row, a
  biased head.
- Rotary angles, written as EVA-CLIP's `VisionRotaryEmbeddingFast` writes
  them: frequencies 10000^(−j/(dh/4)), the grid's positions t = index /
  grid · ref_grid, their outer product repeated in pairs, the row table and
  the column table concatenated; a head's vector x turns as
  x·cos + rotate_half(x)·sin with rotate_half((a, b)) = (−b, a) per pair.
- Text: open_clip's causal blocks (one in-projection, exact-erf GELU),
  `ln_final`, the end-of-text row (the largest id) through
  `text_projection`.
- Tokens: CLIP's tokenizer without a merges file (byte-level tokens: each
  UTF-8 byte of a word is a token, the word's last byte carries `</w>`), for
  captions of lowercase ASCII words and digits.

Departures from the published model: the BPE merges are not in the
repository, so captions are byte-level tokens; the weights are random from a
seed, not the released checkpoint's.

`precision` picks the arithmetic of every matrix product and convolution:
- "f32": float32, TF32 off (the reference);
- "fp8": each product's operands rounded to float8 e4m3 with a per-tensor
  scale, accumulated in float32 (the control of a bfloat16 path).
"""

from __future__ import annotations

import io
import re

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0
TRUNK = "visual.trunk."
# openai's bytes_to_unicode lists the printable bytes 33..126 first, so a
# printable ASCII byte b has vocabulary index b - 33, and its `</w>` form
# 256 + b - 33; with no merges the start and end tokens follow at 512, 513
_SOT, _EOT = 512, 513


def preprocess(data: bytes, size: int) -> np.ndarray:
    """Image bytes → (size, size, 3) uint8: shorter side to `size`, bicubic,
    centre crop."""
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
    """Byte-level CLIP tokens: words of letters, and each digit a word of its
    own (CLIP's pre-tokenizer), framed by the start and end tokens, cut with
    the end token kept last, zero-padded."""
    if not all(c == " " or "a" <= c <= "z" or "0" <= c <= "9" for c in caption):
        raise ValueError(f"the reference tokenizes lowercase ASCII words and digits only: {caption!r}")
    ids = [_SOT]
    for word in re.findall(r"[a-z]+|[0-9]", caption):
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

    def matmul(self, x, w):
        x, w = self.ops(x, w)
        return x @ w

    def conv(self, x, w, b, stride):
        x, w = self.ops(x, w)
        return F.conv2d(x, w, b, stride=stride)


def _layer_norm(x, sd, p, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], eps)


def rope_cos_sin(grid: int, ref_grid: int, head_dim: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(grid², head_dim) cos and sin of each patch row, row-major over the
    grid, in EVA-CLIP's form (`VisionRotaryEmbeddingFast`, pt_seq_len =
    ref_grid, ft_seq_len = grid)."""
    dim = head_dim // 2  # each axis's share of the head
    freqs = 1.0 / (10000 ** (torch.arange(0, dim, 2, device=device)[: dim // 2].float() / dim))
    t = torch.arange(grid, device=device).float() / grid * ref_grid
    freqs = torch.einsum("i,f->if", t, freqs).repeat_interleave(2, dim=-1)  # (grid, dim): pairs share an angle
    freqs = torch.cat([freqs[:, None, :].expand(grid, grid, dim), freqs[None, :, :].expand(grid, grid, dim)], dim=-1)
    freqs = freqs.reshape(grid * grid, head_dim)
    return freqs.cos(), freqs.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x·cos + rotate_half(x)·sin, rotate_half turning each pair (a, b) into (−b, a)."""
    half = torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).flatten(-2)
    return x * cos + half * sin


def _attend(a: Arith, q, k, v, heads, causal=False, rope=None):
    """softmax(q·kᵀ·dh^-1/2 [causal])·v per head on (B, S, W); `rope` (cos,
    sin) turns q and k of the rows after the class row."""
    b, s, w = q.shape
    split = lambda t: t.reshape(b, s, heads, w // heads).transpose(1, 2)  # noqa: E731
    q, k, v = split(q), split(k), split(v)
    if rope is not None:
        q = torch.cat([q[:, :, :1], rotate(q[:, :, 1:], *rope)], dim=2)
        k = torch.cat([k[:, :, :1], rotate(k[:, :, 1:], *rope)], dim=2)
    q, k = a.ops(q, k)
    scores = (q @ k.transpose(-1, -2)) * (w // heads) ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    p_attn, v = a.ops(scores.softmax(dim=-1), v)
    return (p_attn @ v).transpose(1, 2).reshape(b, s, w)


def normalize_pixels(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) → CLIP-normalized float32 (B, 3, H, W)."""
    x = images_u8.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def image_features(a: Arith, x: torch.Tensor, sd: dict, cfg: dict) -> torch.Tensor:
    """Normalized pixels (B, 3, H, W) → unnormalized (B, embed) features."""
    t, p, w = TRUNK, cfg["patch_size"], cfg["vision_width"]
    x = a.conv(x, sd[t + "patch_embed.proj.weight"], sd[t + "patch_embed.proj.bias"], p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd[t + "cls_token"].expand(x.shape[0], 1, w), x], dim=1) + sd[t + "pos_embed"]
    eps, heads = cfg["layernorm_eps"], cfg["vision_heads"]
    rope = rope_cos_sin(cfg["image_size"] // p, cfg["rope_grid"], w // heads, x.device)
    for i in range(cfg["vision_layers"]):
        b = f"{t}blocks.{i}."
        h = _layer_norm(x, sd, b + "norm1", eps)
        q = a.linear(h, sd[b + "attn.q_proj.weight"], sd[b + "attn.q_proj.bias"])
        k = a.linear(h, sd[b + "attn.k_proj.weight"])
        v = a.linear(h, sd[b + "attn.v_proj.weight"], sd[b + "attn.v_proj.bias"])
        o = _layer_norm(_attend(a, q, k, v, heads, rope=rope), sd, b + "attn.norm", eps)
        x = x + a.linear(o, sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"])
        h = _layer_norm(x, sd, b + "norm2", eps)
        g = a.linear(h, sd[b + "mlp.fc1_g.weight"], sd[b + "mlp.fc1_g.bias"])
        h = F.silu(g) * a.linear(h, sd[b + "mlp.fc1_x.weight"], sd[b + "mlp.fc1_x.bias"])
        h = _layer_norm(h, sd, b + "mlp.norm", eps)
        x = x + a.linear(h, sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"])
    x = _layer_norm(x, sd, t + "norm", eps)
    return a.linear(x[:, 0], sd[t + "head.weight"], sd[t + "head.bias"])


def text_features(a: Arith, tokens: torch.Tensor, sd: dict, cfg: dict) -> torch.Tensor:
    """int (B, context) ids → unnormalized (B, embed) features."""
    tokens = tokens.long()
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"][: tokens.shape[1]]
    eps, heads, w = cfg["text_layernorm_eps"], cfg["text_heads"], cfg["text_width"]
    for i in range(cfg["text_layers"]):
        b = f"transformer.resblocks.{i}."
        h = _layer_norm(x, sd, b + "ln_1", eps)
        q, k, v = a.linear(h, sd[b + "attn.in_proj_weight"], sd[b + "attn.in_proj_bias"]).split(w, dim=-1)
        o = _attend(a, q, k, v, heads, causal=True)
        x = x + a.linear(o, sd[b + "attn.out_proj.weight"], sd[b + "attn.out_proj.bias"])
        h = _layer_norm(x, sd, b + "ln_2", eps)
        h = F.gelu(a.linear(h, sd[b + "mlp.c_fc.weight"], sd[b + "mlp.c_fc.bias"]))
        x = x + a.linear(h, sd[b + "mlp.c_proj.weight"], sd[b + "mlp.c_proj.bias"])
    x = _layer_norm(x, sd, "ln_final", eps)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return a.matmul(x, sd["text_projection"])


def encode_image(sd: dict, cfg: dict, images_u8: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """uint8 (B, H, W, 3) preprocessed images → L2-normalized float32 (B, embed)."""
    a = Arith(precision)
    return F.normalize(image_features(a, normalize_pixels(images_u8), sd, cfg), dim=-1)


def encode_text(sd: dict, cfg: dict, tokens: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """int (B, context) token ids → L2-normalized float32 (B, embed)."""
    a = Arith(precision)
    return F.normalize(text_features(a, tokens, sd, cfg), dim=-1)

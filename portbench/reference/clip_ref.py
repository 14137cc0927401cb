"""Plain CLIP forward over an openai-layout state dict, after openai CLIP's
`clip/model.py` (VisionTransformer and the causal text Transformer), in
float32.

`precision` picks the arithmetic of every matrix product and convolution:
- "f32": float32 (the reference);
- "fp8": each product's operands rounded to float8 e4m3 with a per-tensor
  scale, accumulated in float32 (the control of a bfloat16 path).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision!r}")
        self.fp8 = precision == "fp8"

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

    def conv(self, x, w, stride=1, padding=0):
        x, w = self.ops(x, w)
        return F.conv2d(x, w, stride=stride, padding=padding)


def _layer_norm(x, sd, p, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], eps)


def _mha(a: Arith, x, sd, p, heads, causal):
    """nn.MultiheadAttention(x, x, x) of openai's ResidualAttentionBlock, batch first."""
    b, s, w = x.shape
    qkv = a.linear(x, sd[p + ".in_proj_weight"], sd[p + ".in_proj_bias"])
    q, k, v = (t.reshape(b, s, heads, w // heads).transpose(1, 2) for t in qkv.split(w, dim=-1))
    q, k = a.ops(q, k)
    scores = (q @ k.transpose(-1, -2)) * (w // heads) ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    p_attn, v = a.ops(scores.softmax(dim=-1), v)
    o = (p_attn @ v).transpose(1, 2).reshape(b, s, w)
    return a.linear(o, sd[p + ".out_proj.weight"], sd[p + ".out_proj.bias"])


def _transformer(a: Arith, x, sd, prefix, layers, heads, eps, causal):
    for i in range(layers):
        p = f"{prefix}resblocks.{i}"
        x = x + _mha(a, _layer_norm(x, sd, p + ".ln_1", eps), sd, p + ".attn", heads, causal)
        h = a.linear(_layer_norm(x, sd, p + ".ln_2", eps), sd[p + ".mlp.c_fc.weight"], sd[p + ".mlp.c_fc.bias"])
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        x = x + a.linear(h, sd[p + ".mlp.c_proj.weight"], sd[p + ".mlp.c_proj.bias"])
    return x


def normalize_pixels(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) → CLIP-normalized float32 (B, 3, H, W)."""
    x = images_u8.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def _vit(a: Arith, x, sd, cfg):
    p = cfg["patch_size"]
    x = a.conv(x, sd["visual.conv1.weight"], stride=p)  # (B, W, g, g)
    x = x.flatten(2).transpose(1, 2)
    cls = sd["visual.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"]
    eps = cfg["layernorm_eps"]
    x = _layer_norm(x, sd, "visual.ln_pre", eps)
    x = _transformer(a, x, sd, "visual.transformer.", cfg["vision_layers"], cfg["vision_heads"], eps, False)
    x = _layer_norm(x[:, 0], sd, "visual.ln_post", eps)
    return a.matmul(x, sd["visual.proj"])


def encode_image(sd: dict, cfg: dict, images_u8: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """uint8 (B, H, W, 3) images → L2-normalized float32 (B, embed_dim)."""
    a = Arith(precision)
    x = normalize_pixels(images_u8)
    return F.normalize(_vit(a, x, sd, cfg).float(), dim=-1)


def encode_text(sd: dict, cfg: dict, tokens: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """int (B, context) token ids → L2-normalized float32 (B, embed_dim),
    pooled at the end-of-text token (the largest id)."""
    a = Arith(precision)
    tokens = tokens.long()
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"][: tokens.shape[1]]
    eps = cfg["layernorm_eps"]
    x = _transformer(a, x, sd, "transformer.", cfg["text_layers"], cfg["text_heads"], eps, True)
    x = _layer_norm(x, sd, "ln_final", eps)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return F.normalize(a.matmul(x, sd["text_projection"]).float(), dim=-1)

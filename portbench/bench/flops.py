"""Model FLOPs per sample, counted from a configuration's shapes (a
multiply-add is two FLOPs; layer norms, activations and softmax are left
out).  Attention counts q·kᵀ and p·v; the causal text tower only the pairs
on or below the diagonal."""

from __future__ import annotations


def _blocks(tokens: int, width: int, mlp_ratio: float, layers: int, causal: bool) -> float:
    pairs = tokens * (tokens + 1) / 2 if causal else tokens * tokens
    mlp = int(round(width * mlp_ratio))
    per_layer = 2.0 * tokens * (4 * width * width + 2 * width * mlp) + 4.0 * pairs * width
    return layers * per_layer


def text_tower(cfg: dict) -> float:
    s, w = cfg["context_length"], cfg["text_width"]
    return _blocks(s, w, cfg["text_mlp_ratio"], cfg["text_layers"], True) + 2.0 * w * cfg["embed_dim"]


def image_tower(cfg: dict) -> float:
    p, w = cfg["patch_size"], cfg["vision_width"]
    g = cfg["image_size"] // p
    patch = 2.0 * g * g * p * p * 3 * w
    return patch + _blocks(g * g + 1, w, cfg["vision_mlp_ratio"], cfg["vision_layers"], False) + 2.0 * w * cfg["embed_dim"]

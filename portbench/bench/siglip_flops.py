"""Model FLOPs per sample of a SigLIP configuration, counted from its shapes
as `bench/flops.py` counts CLIP's (a multiply-add is two FLOPs; layer norms,
activations and softmax are left out; attention counts q·kᵀ and p·v).

- Image: the patch convolution over the g·g patches (no class token), the
  blocks over g·g tokens with every pair attended (no mask), and the pooling
  head: its k and v projections over the g·g tokens, and for its one query
  row the q projection, q·kᵀ and p·v over the g·g keys, the out projection
  and the MLP.  No projection follows.
- Text: the blocks over the context with every pair attended (no causal
  mask, padding included), then the head, a Linear of text_width × embed_dim
  at the last position.
"""

from __future__ import annotations


def _blocks(tokens: int, width: int, mlp: int, layers: int) -> float:
    per_layer = 2.0 * tokens * (4 * width * width + 2 * width * mlp) + 4.0 * tokens * tokens * width
    return layers * per_layer


def image_tower(cfg: dict) -> float:
    p, w, mlp = cfg["patch_size"], cfg["vision_width"], cfg["vision_mlp_dim"]
    n = (cfg["image_size"] // p) ** 2
    patch = 2.0 * n * p * p * 3 * w
    head = 2.0 * n * 2 * w * w + 2.0 * (2 * w * w + 2 * w * mlp) + 4.0 * n * w
    return patch + _blocks(n, w, mlp, cfg["vision_layers"]) + head


def text_tower(cfg: dict) -> float:
    s, w = cfg["context_length"], cfg["text_width"]
    return _blocks(s, w, cfg["text_mlp_dim"], cfg["text_layers"]) + 2.0 * w * cfg["embed_dim"]

"""Model FLOPs per sample of an EVA02-CLIP configuration, counted from its
shapes as `bench/flops.py` counts CLIP's (a multiply-add is two FLOPs; layer
norms, activations, the gate, the rotation and softmax are left out;
attention counts q·kᵀ and p·v).

- Image: the patch convolution over the g·g patches; the blocks over g·g + 1
  tokens with every pair attended (no mask), each with four width² products
  (q, k, v, out) and three of width × hidden (the gate, x and out of the
  SwiGLU), the hidden counted at the model's width (2730 at EVA02-L),
  whatever the program pads; the head, a Linear of width × embed_dim at the
  class row.
- Text: CLIP's causal tower (`bench/flops.py`).
"""

from __future__ import annotations

from . import flops


def image_tower(cfg: dict) -> float:
    p, w, h = cfg["patch_size"], cfg["vision_width"], cfg["vision_mlp_dim"]
    g = cfg["image_size"] // p
    n = g * g + 1
    per_layer = 2.0 * n * (4 * w * w + 3 * w * h) + 4.0 * n * n * w
    return 2.0 * g * g * p * p * 3 * w + cfg["vision_layers"] * per_layer + 2.0 * w * cfg["embed_dim"]


def text_tower(cfg: dict) -> float:
    return flops.text_tower(cfg)

"""Seeded CLIP weights in the openai state-dict layout, made on the device.

One `torch.randn` call on the card fills a single f32 buffer; every tensor
of the state dict is a view of it, scaled in place.  Scales follow openai
CLIP's `initialize_parameters` (token embedding 0.02, positions 0.01,
attention in-projections width^-1/2, out-projections and MLP outputs
width^-1/2 · (2·layers)^-1/2, MLP inputs (2·width)^-1/2, projections
width^-1/2; the patch convolution fan-in^-1/2), with departures stated in
each configuration's `assumed`: biases and LayerNorm affines are small
random values instead of 0 and 1, so that a dropped bias or affine shows in
the comparison.

The program and the plain reference receive the same tensors.
"""

from __future__ import annotations

import math


def _vit_text_shapes(cfg: dict, prefix: str, width: int, layers: int, mlp: int) -> list:
    out = []
    proj_std = width ** -0.5 * (2 * layers) ** -0.5
    for i in range(layers):
        p = f"{prefix}resblocks.{i}."
        out += [
            (p + "ln_1.weight", (width,), "ln_w"), (p + "ln_1.bias", (width,), "bias"),
            (p + "attn.in_proj_weight", (3 * width, width), width ** -0.5),
            (p + "attn.in_proj_bias", (3 * width,), "bias"),
            (p + "attn.out_proj.weight", (width, width), proj_std),
            (p + "attn.out_proj.bias", (width,), "bias"),
            (p + "ln_2.weight", (width,), "ln_w"), (p + "ln_2.bias", (width,), "bias"),
            (p + "mlp.c_fc.weight", (mlp, width), (2 * width) ** -0.5),
            (p + "mlp.c_fc.bias", (mlp,), "bias"),
            (p + "mlp.c_proj.weight", (width, mlp), proj_std),
            (p + "mlp.c_proj.bias", (width,), "bias"),
        ]
    return out


def state_dict_shapes(cfg: dict) -> list:
    """(key, shape, scale or kind) of every tensor of the openai state dict."""
    w, p = cfg["vision_width"], cfg["patch_size"]
    grid = cfg["image_size"] // p
    out = [
        ("visual.conv1.weight", (w, 3, p, p), (3 * p * p) ** -0.5),
        ("visual.class_embedding", (w,), w ** -0.5),
        ("visual.positional_embedding", (grid * grid + 1, w), w ** -0.5),
        ("visual.ln_pre.weight", (w,), "ln_w"), ("visual.ln_pre.bias", (w,), "bias"),
    ]
    out += _vit_text_shapes(cfg, "visual.transformer.", w, cfg["vision_layers"],
                            int(round(w * cfg["vision_mlp_ratio"])))
    out += [
        ("visual.ln_post.weight", (w,), "ln_w"), ("visual.ln_post.bias", (w,), "bias"),
        ("visual.proj", (w, cfg["embed_dim"]), w ** -0.5),
    ]
    tw = cfg["text_width"]
    out += [
        ("token_embedding.weight", (cfg["vocab_size"], tw), 0.02),
        ("positional_embedding", (cfg["context_length"], tw), 0.01),
    ]
    out += _vit_text_shapes(cfg, "transformer.", tw, cfg["text_layers"], int(round(tw * cfg["text_mlp_ratio"])))
    out += [
        ("ln_final.weight", (tw,), "ln_w"), ("ln_final.bias", (tw,), "bias"),
        ("text_projection", (tw, cfg["embed_dim"]), tw ** -0.5),
    ]
    return out


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    """The whole openai-layout state dict at `cfg`'s widths, f32 on `device`."""
    import torch

    shapes = state_dict_shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device)
    sd, off = {}, 0
    with torch.no_grad():
        for key, shape, kind in shapes:
            n = math.prod(shape)
            t = buf[off : off + n].view(shape)
            off += n
            if kind == "bias":
                t.mul_(0.02)
            elif kind == "ln_w":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(kind)
            sd[key] = t
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device)
    return sd

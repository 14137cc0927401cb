"""Seeded EVA02-CLIP weights in the layout of an open_clip `EVA02-L-14-336`
state dict (timm's `Eva` trunk under `visual.trunk.`, open_clip's text
tower), made on the device.

One `torch.randn` call on the card fills a single f32 buffer; every tensor
of the state dict is a view of it, scaled in place: Linear and convolution
weights fan-in^-1/2, the class token and the image positions 0.02 (timm's
init), the token embedding 0.02, the text positions 0.01, the text
projection width^-1/2; biases 0.02·N(0, 1) and LayerNorm weights 1 +
0.1·N(0, 1), so that a dropped bias or affine shows in the comparison (the
configuration's `assumed`).  k's product has no bias, as in the model.  The
program and the plain reference receive the same tensors.
"""

from __future__ import annotations

import math


def _linear(name: str, n_out: int, n_in: int, bias: bool = True) -> list:
    out = [(name + ".weight", (n_out, n_in), n_in ** -0.5)]
    return out + [(name + ".bias", (n_out,), "bias")] if bias else out


def _ln(name: str, width: int) -> list:
    return [(name + ".weight", (width,), "ln_w"), (name + ".bias", (width,), "bias")]


def state_dict_shapes(cfg: dict) -> list:
    """(key, shape, scale or kind) of every tensor of the open_clip EVA02
    state dict at `cfg`'s widths, in its order."""
    w, tw, p, h = cfg["vision_width"], cfg["text_width"], cfg["patch_size"], cfg["vision_mlp_dim"]
    grid = cfg["image_size"] // p
    t = "visual.trunk."
    out = [(t + "cls_token", (1, 1, w), 0.02), (t + "pos_embed", (1, grid * grid + 1, w), 0.02),
           (t + "patch_embed.proj.weight", (w, 3, p, p), (3 * p * p) ** -0.5),
           (t + "patch_embed.proj.bias", (w,), "bias")]
    for i in range(cfg["vision_layers"]):
        b = f"{t}blocks.{i}."
        out += _ln(b + "norm1", w) + _linear(b + "attn.q_proj", w, w) + _linear(b + "attn.k_proj", w, w, bias=False)
        out += _linear(b + "attn.v_proj", w, w) + _ln(b + "attn.norm", w) + _linear(b + "attn.proj", w, w)
        out += _ln(b + "norm2", w) + _linear(b + "mlp.fc1_g", h, w) + _linear(b + "mlp.fc1_x", h, w)
        out += _ln(b + "mlp.norm", h) + _linear(b + "mlp.fc2", w, h)
    out += _ln(t + "norm", w) + _linear(t + "head", cfg["embed_dim"], w)
    out += [("positional_embedding", (cfg["context_length"], tw), 0.01),
            ("text_projection", (tw, cfg["embed_dim"]), tw ** -0.5),
            ("logit_scale", (), "logit_scale"),
            ("token_embedding.weight", (cfg["vocab_size"], tw), 0.02)]
    m = cfg["text_mlp_dim"]
    for i in range(cfg["text_layers"]):
        b = f"transformer.resblocks.{i}."
        out += _ln(b + "ln_1", tw) + [(b + "attn.in_proj_weight", (3 * tw, tw), tw ** -0.5),
                                      (b + "attn.in_proj_bias", (3 * tw,), "bias")]
        out += _linear(b + "attn.out_proj", tw, tw) + _ln(b + "ln_2", tw)
        out += _linear(b + "mlp.c_fc", m, tw) + _linear(b + "mlp.c_proj", tw, m)
    return out + _ln("ln_final", tw)


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    """The whole open_clip EVA02 state dict at `cfg`'s widths, f32 on `device`."""
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
            elif kind == "logit_scale":
                t.fill_(math.log(1 / 0.07))
            else:
                t.mul_(kind)
            sd[key] = t
    return sd

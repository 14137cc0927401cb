"""Seeded SigLIP weights in the layout of `transformers.SiglipModel`'s state
dict, made on the device.

One `torch.randn` call on the card fills a single f32 buffer; every tensor
of the state dict is a view of it, scaled in place: Linear, convolution and
probe weights fan-in^-1/2, the token embedding 0.02 and both position
embeddings 0.01; biases 0.02·N(0, 1) and LayerNorm weights 1 + 0.1·N(0, 1),
so that a dropped bias or affine shows in the comparison (the
configuration's `assumed`).  The program and the plain reference receive the
same tensors.
"""

from __future__ import annotations

import math


def _linear(name: str, n_out: int, n_in: int) -> list:
    return [(name + ".weight", (n_out, n_in), n_in ** -0.5), (name + ".bias", (n_out,), "bias")]


def _ln(name: str, width: int) -> list:
    return [(name + ".weight", (width,), "ln_w"), (name + ".bias", (width,), "bias")]


def _encoder(prefix: str, width: int, layers: int, mlp: int) -> list:
    out = []
    for i in range(layers):
        p = f"{prefix}.encoder.layers.{i}."
        out += _ln(p + "layer_norm1", width)
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            out += _linear(p + "self_attn." + proj, width, width)
        out += _ln(p + "layer_norm2", width)
        out += _linear(p + "mlp.fc1", mlp, width) + _linear(p + "mlp.fc2", width, mlp)
    return out


def state_dict_shapes(cfg: dict) -> list:
    """(key, shape, scale or kind) of every tensor of the SiglipModel state
    dict at `cfg`'s widths, in its order."""
    w, tw, p = cfg["vision_width"], cfg["text_width"], cfg["patch_size"]
    grid = cfg["image_size"] // p
    out = [("logit_scale", (1,), "logit_scale"), ("logit_bias", (1,), "logit_bias"),
           ("text_model.embeddings.token_embedding.weight", (cfg["vocab_size"], tw), 0.02),
           ("text_model.embeddings.position_embedding.weight", (cfg["context_length"], tw), 0.01)]
    out += _encoder("text_model", tw, cfg["text_layers"], cfg["text_mlp_dim"])
    out += _ln("text_model.final_layer_norm", tw) + _linear("text_model.head", cfg["embed_dim"], tw)
    out += [("vision_model.embeddings.patch_embedding.weight", (w, 3, p, p), (3 * p * p) ** -0.5),
            ("vision_model.embeddings.patch_embedding.bias", (w,), "bias"),
            ("vision_model.embeddings.position_embedding.weight", (grid * grid, w), 0.01)]
    out += _encoder("vision_model", w, cfg["vision_layers"], cfg["vision_mlp_dim"])
    h = "vision_model.head."
    out += _ln("vision_model.post_layernorm", w)
    out += [(h + "probe", (1, 1, w), w ** -0.5), (h + "attention.in_proj_weight", (3 * w, w), w ** -0.5),
            (h + "attention.in_proj_bias", (3 * w,), "bias")]
    out += _linear(h + "attention.out_proj", w, w) + _ln(h + "layernorm", w)
    out += _linear(h + "mlp.fc1", cfg["vision_mlp_dim"], w) + _linear(h + "mlp.fc2", w, cfg["vision_mlp_dim"])
    return out


def make_state_dict(cfg: dict, seed: int, device) -> dict:
    """The whole SiglipModel state dict at `cfg`'s widths, f32 on `device`."""
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
                t.fill_(math.log(10.0))  # SigLIP's initial temperature and bias
            elif kind == "logit_bias":
                t.fill_(-10.0)
            else:
                t.mul_(kind)
            sd[key] = t
    return sd

"""Checkpoint loading: JAX param trees and torch/HF CLIP weights → `CLIP`.

Counterpart of `clip_retrieval_tpu/models/loaders.py`, with the same key maps
for ViT towers:

- HF `transformers.CLIPModel` state dicts  (keys `vision_model.*`)
- openai CLIP / open_clip state dicts      (keys `visual.*`, fused in_proj)
- the JAX package's own param tree          (`from_jax_params`)
- HF `transformers.SiglipModel` state dicts (`vision_model.head.probe`;
  `convert_siglip_state_dict`), which no JAX tree holds: their tree carries
  the SigLIP entries (`patch_embed.bias`, `head`, the text `proj_bias`)
  and leaves out `class_emb`, `ln_pre` and the image `proj`
- open_clip EVA02 state dicts (timm's `Eva` trunk under `visual.trunk.`,
  open_clip's text tower; `convert_eva_state_dict`), which no JAX tree
  holds either: their tree carries `patch_embed.bias`, the image
  `proj_bias`, each block's `attn.ln` and the SwiGLU's `mlp.w_gate`,
  `mlp.b_gate` and `mlp.ln`, and leaves out `ln_pre`

Every source is first turned into the JAX package's nested tree of numpy
arrays (blocks stacked on a leading layer axis, x@W kernels), and
`from_jax_params` copies that tree into the port's modules.  An openai
ModifiedResNet checkpoint (RN50…RN50x64) has its BatchNorms folded into the
preceding convolutions (`_fold_conv_bn`, in f64) and becomes the JAX
package's ResNet tree (HWIO kernels, each stage's tail blocks stacked on a
leading axis, `None` for a one-block stage); `from_jax_params` turns the
kernels to the port's OIHW.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..utils.device import resolve_device
from .clip import CLIP
from .configs import CLIPConfig


def _np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        # bf16/fp8 tensors have no numpy dtype: upcast first
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def _stack(sd: Mapping[str, Any], fmt: str, n: int) -> np.ndarray:
    return np.stack([_np(sd[fmt.format(i=i)]) for i in range(n)])


# ---------------------------------------------------------------------------
# JAX param tree → modules
# ---------------------------------------------------------------------------


def _copy(dst: torch.Tensor, src, name: str):
    arr = np.array(src, dtype=np.float32, order="C")  # a writable copy, 0-d stays 0-d
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape} does not match the model's {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr))


def _copy_ln(ln, tree: Mapping[str, Any], name: str):
    for leaf in ("scale", "bias"):
        _copy(getattr(ln, leaf), tree[leaf], f"{name}.{leaf}")


def _copy_attn_mlp(blk, tree: Mapping[str, Any], prefix: str, pick):
    for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"):
        _copy(getattr(blk.attn, name), pick(tree["attn"][name]), f"{prefix}.attn.{name}")
    for name in ("w_gate", "b_gate", "w_in", "b_in", "w_out", "b_out"):
        if hasattr(blk.mlp, name):
            _copy(getattr(blk.mlp, name), pick(tree["mlp"][name]), f"{prefix}.mlp.{name}")
    for sub in ("attn", "mlp"):  # EVA02's inner LayerNorms
        ln = getattr(getattr(blk, sub), "ln", None)
        if ln is not None:
            for leaf in ("scale", "bias"):
                _copy(getattr(ln, leaf), pick(tree[sub]["ln"][leaf]), f"{prefix}.{sub}.ln.{leaf}")


def _copy_blocks(blocks, tree: Mapping[str, Any], prefix: str):
    for i, blk in enumerate(blocks):
        for sub in ("ln_1", "ln_2"):
            for name in ("scale", "bias"):
                _copy(getattr(getattr(blk, sub), name), tree[sub][name][i], f"{prefix}.{sub}.{name}[{i}]")
        _copy_attn_mlp(blk, tree, f"{prefix}[{i}]", lambda a: a[i])


def _copy_conv(conv, tree: Mapping[str, Any], name: str, i: int | None = None):
    """One folded conv of the JAX ResNet tree (HWIO kernel; `i` picks a
    block of a stacked tail) → `resnet.Conv` (OIHW)."""
    pick = (lambda a: np.asarray(a)) if i is None else (lambda a: np.asarray(a)[i])
    _copy(conv.kernel, pick(tree["kernel"]).transpose(3, 2, 0, 1), f"{name}.kernel")
    for leaf in ("scale", "bias"):
        _copy(getattr(conv, leaf), pick(tree[leaf]), f"{name}.{leaf}")


def _copy_bottleneck(blk, tree: Mapping[str, Any], name: str, i: int | None = None):
    for conv in ("conv1", "conv2", "conv3", "down"):
        if (getattr(blk, conv) is None) != (conv not in tree):
            raise ValueError(f"{name}.{conv}: the tree and the model disagree on whether it exists")
        if conv in tree:
            _copy_conv(getattr(blk, conv), tree[conv], f"{name}.{conv}", i)


def _copy_resnet_visual(v, vt: Mapping[str, Any]):
    for conv in ("conv1", "conv2", "conv3"):
        _copy_conv(getattr(v.stem, conv), vt["stem"][conv], f"visual.stem.{conv}")
    if len(vt["stages"]) != len(v.stages):
        raise ValueError(f"visual.stages: {len(vt['stages'])} stages for the model's {len(v.stages)}")
    for si, (stage, st) in enumerate(zip(v.stages, vt["stages"])):
        name = f"visual.stages[{si}]"
        _copy_bottleneck(stage.head, st["head"], f"{name}.head")
        n_tail = 0 if st["tail"] is None else len(st["tail"]["conv1"]["kernel"])
        if n_tail != len(stage.tail):
            raise ValueError(f"{name}.tail: {n_tail} blocks for the model's {len(stage.tail)}")
        for i, blk in enumerate(stage.tail):
            _copy_bottleneck(blk, st["tail"], f"{name}.tail[{i}]", i)
    for leaf in ("pos_emb", "wq", "bq", "wk", "bk", "wv", "bv", "wc", "bc"):
        _copy(getattr(v.attnpool, leaf), vt["attnpool"][leaf], f"visual.attnpool.{leaf}")


def from_jax_params(tree: Mapping[str, Any], cfg: CLIPConfig, device: str | torch.device = "cuda") -> CLIP:
    """The JAX package's param tree (arrays as numpy, blocks stacked on a
    leading layer axis) → a `CLIP` module on `device`, weights in f32.  The
    default device is CUDA; without a GPU it raises unless given "cpu"."""
    device = resolve_device(device)
    model = CLIP(cfg, torch.device("cpu"))
    vt, tt = tree["visual"], tree["text"]
    v, t = model.visual, model.text
    with torch.no_grad():
        if cfg.vision_kind == "resnet":
            _copy_resnet_visual(v, vt)
        else:
            _copy(v.patch_embed.kernel, vt["patch_embed"]["kernel"], "visual.patch_embed.kernel")
            if v.patch_embed.bias is not None:
                _copy(v.patch_embed.bias, vt["patch_embed"]["bias"], "visual.patch_embed.bias")
            for name in ("class_emb", "pos_emb", "proj", "proj_bias"):
                if getattr(v, name) is not None:
                    _copy(getattr(v, name), vt[name], f"visual.{name}")
            for ln in ("ln_pre", "ln_post"):
                if getattr(v, ln) is not None:
                    _copy_ln(getattr(v, ln), vt[ln], f"visual.{ln}")
            _copy_blocks(v.blocks, vt["blocks"], "visual.blocks")
            if v.head is not None:
                ht = vt["head"]
                _copy(v.head.probe, ht["probe"], "visual.head.probe")
                _copy_ln(v.head.ln, ht["ln"], "visual.head.ln")
                _copy_attn_mlp(v.head, ht, "visual.head", lambda a: a)
        for name in ("token_emb", "pos_emb", "proj", "proj_bias"):
            if getattr(t, name) is not None:
                _copy(getattr(t, name), tt[name], f"text.{name}")
        for name in ("scale", "bias"):
            _copy(getattr(t.ln_final, name), tt["ln_final"][name], f"text.ln_final.{name}")
        _copy_blocks(t.blocks, tt["blocks"], "text.blocks")
        _copy(model.logit_scale, np.reshape(tree["logit_scale"], ()), "logit_scale")
    return model.to(device)


# ---------------------------------------------------------------------------
# HF transformers CLIPModel
# ---------------------------------------------------------------------------


def _hf_tower(sd, prefix: str, n_layers: int):
    L = prefix + ".encoder.layers.{i}."

    def ws(name):  # linear weight, (out, in) → (L, in, out)
        return _stack(sd, L + name + ".weight", n_layers).transpose(0, 2, 1)

    def bs(name):
        return _stack(sd, L + name + ".bias", n_layers)

    return {
        "ln_1": {"scale": _stack(sd, L + "layer_norm1.weight", n_layers), "bias": bs("layer_norm1")},
        "attn": {
            "wq": ws("self_attn.q_proj"),
            "wk": ws("self_attn.k_proj"),
            "wv": ws("self_attn.v_proj"),
            "wo": ws("self_attn.out_proj"),
            "bq": bs("self_attn.q_proj"),
            "bk": bs("self_attn.k_proj"),
            "bv": bs("self_attn.v_proj"),
            "bo": bs("self_attn.out_proj"),
        },
        "ln_2": {"scale": _stack(sd, L + "layer_norm2.weight", n_layers), "bias": bs("layer_norm2")},
        "mlp": {"w_in": ws("mlp.fc1"), "b_in": bs("mlp.fc1"), "w_out": ws("mlp.fc2"), "b_out": bs("mlp.fc2")},
    }


def hf_tree(sd: Mapping[str, Any], cfg: CLIPConfig) -> dict:
    """HF CLIPModel state dict → the JAX package's param tree (numpy)."""
    g = lambda k: _np(sd[k])
    # HF has a typo'd key "pre_layrnorm" in CLIPVisionTransformer
    pre_ln = "vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd else "vision_model.pre_layernorm"
    visual = {
        # (W, 3, P, P) → (P, P, 3, W)
        "patch_embed": {"kernel": g("vision_model.embeddings.patch_embedding.weight").transpose(2, 3, 1, 0)},
        "class_emb": g("vision_model.embeddings.class_embedding").reshape(-1),
        "pos_emb": g("vision_model.embeddings.position_embedding.weight"),
        "ln_pre": {"scale": g(pre_ln + ".weight"), "bias": g(pre_ln + ".bias")},
        "blocks": _hf_tower(sd, "vision_model", cfg.vision_layers),
        "ln_post": {"scale": g("vision_model.post_layernorm.weight"), "bias": g("vision_model.post_layernorm.bias")},
        "proj": g("visual_projection.weight").T,
    }
    text = {
        "token_emb": g("text_model.embeddings.token_embedding.weight"),
        "pos_emb": g("text_model.embeddings.position_embedding.weight"),
        "blocks": _hf_tower(sd, "text_model", cfg.text_layers),
        "ln_final": {"scale": g("text_model.final_layer_norm.weight"), "bias": g("text_model.final_layer_norm.bias")},
        "proj": g("text_projection.weight").T,
    }
    return {"visual": visual, "text": text, "logit_scale": g("logit_scale").reshape(())}


def convert_hf_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig, device: str | torch.device = "cuda") -> CLIP:
    device = resolve_device(device)
    return from_jax_params(hf_tree(sd, cfg), cfg, device)


# ---------------------------------------------------------------------------
# HF transformers SiglipModel
# ---------------------------------------------------------------------------


def siglip_tree(sd: Mapping[str, Any], cfg: CLIPConfig) -> dict:
    """HF SiglipModel state dict → a param tree in the JAX package's layout
    with SigLIP's entries (Linear weights (out, in) transposed to x@W, the
    pooling head's stacked q|k|v `in_proj` split)."""
    g = lambda k: _np(sd[k])
    lin = lambda k: g(k + ".weight").T  # noqa: E731
    ln = lambda k: {"scale": g(k + ".weight"), "bias": g(k + ".bias")}  # noqa: E731
    h, w = "vision_model.head.", cfg.vision_width
    in_w, in_b = g(h + "attention.in_proj_weight"), g(h + "attention.in_proj_bias")
    head = {
        "probe": g(h + "probe").reshape(-1),
        "attn": {
            "wq": in_w[:w].T, "wk": in_w[w : 2 * w].T, "wv": in_w[2 * w :].T, "wo": lin(h + "attention.out_proj"),
            "bq": in_b[:w], "bk": in_b[w : 2 * w], "bv": in_b[2 * w :], "bo": g(h + "attention.out_proj.bias"),
        },
        "ln": ln(h + "layernorm"),
        "mlp": {"w_in": lin(h + "mlp.fc1"), "b_in": g(h + "mlp.fc1.bias"), "w_out": lin(h + "mlp.fc2"),
                "b_out": g(h + "mlp.fc2.bias")},
    }
    pe = "vision_model.embeddings.patch_embedding."
    visual = {
        # (W, 3, P, P) → (P, P, 3, W)
        "patch_embed": {"kernel": g(pe + "weight").transpose(2, 3, 1, 0), "bias": g(pe + "bias")},
        "pos_emb": g("vision_model.embeddings.position_embedding.weight"),
        "blocks": _hf_tower(sd, "vision_model", cfg.vision_layers),
        "ln_post": ln("vision_model.post_layernorm"),
        "head": head,
    }
    text = {
        "token_emb": g("text_model.embeddings.token_embedding.weight"),
        "pos_emb": g("text_model.embeddings.position_embedding.weight"),
        "blocks": _hf_tower(sd, "text_model", cfg.text_layers),
        "ln_final": ln("text_model.final_layer_norm"),
        "proj": lin("text_model.head"),
        "proj_bias": g("text_model.head.bias"),
    }
    return {"visual": visual, "text": text, "logit_scale": g("logit_scale").reshape(())}


def convert_siglip_state_dict(
    sd: Mapping[str, Any], cfg: CLIPConfig, device: str | torch.device = "cuda"
) -> CLIP:
    """HF SiglipModel state dict → a `CLIP` module of a SigLIP config on
    `device` (SigLIP's `logit_bias` has no place in an embedding model and is
    not read)."""
    device = resolve_device(device)
    if cfg.pool != "map":
        raise ValueError(f"{cfg.name} is not a SigLIP config (pool {cfg.pool!r})")
    return from_jax_params(siglip_tree(sd, cfg), cfg, device)


# ---------------------------------------------------------------------------
# openai CLIP / open_clip
# ---------------------------------------------------------------------------


def _openai_tower(sd, prefix: str, n_layers: int, width: int):
    L = prefix + ".resblocks.{i}."
    in_w = _stack(sd, L + "attn.in_proj_weight", n_layers)  # (L, 3W, W)
    in_b = _stack(sd, L + "attn.in_proj_bias", n_layers)  # (L, 3W)

    def lin(name):  # (L, out, in) → (L, in, out)
        return _stack(sd, L + name + ".weight", n_layers).transpose(0, 2, 1)

    return {
        "ln_1": {"scale": _stack(sd, L + "ln_1.weight", n_layers), "bias": _stack(sd, L + "ln_1.bias", n_layers)},
        "attn": {
            "wq": in_w[:, :width].transpose(0, 2, 1),
            "wk": in_w[:, width : 2 * width].transpose(0, 2, 1),
            "wv": in_w[:, 2 * width :].transpose(0, 2, 1),
            "wo": lin("attn.out_proj"),
            "bq": in_b[:, :width],
            "bk": in_b[:, width : 2 * width],
            "bv": in_b[:, 2 * width :],
            "bo": _stack(sd, L + "attn.out_proj.bias", n_layers),
        },
        "ln_2": {"scale": _stack(sd, L + "ln_2.weight", n_layers), "bias": _stack(sd, L + "ln_2.bias", n_layers)},
        "mlp": {
            "w_in": lin("mlp.c_fc"),
            "b_in": _stack(sd, L + "mlp.c_fc.bias", n_layers),
            "w_out": lin("mlp.c_proj"),
            "b_out": _stack(sd, L + "mlp.c_proj.bias", n_layers),
        },
    }


def _fold_conv_bn(sd: Mapping[str, Any], conv_key: str, bn_key: str, eps: float = 1e-5) -> dict:
    """Fold an inference BatchNorm into the preceding bias-free conv, in f64:
    gamma·(conv(x) − mean)/sqrt(var + eps) + beta = conv(x)·scale + bias.
    Conv weight (O, I, kh, kw) → HWIO, as in the JAX tree."""
    kernel = _np(sd[conv_key + ".weight"]).transpose(2, 3, 1, 0)
    gamma, beta, mean, var = (
        _np(sd[f"{bn_key}.{k}"]).astype(np.float64) for k in ("weight", "bias", "running_mean", "running_var")
    )
    scale = gamma / np.sqrt(var + eps)
    return {"kernel": kernel, "scale": scale.astype(np.float32), "bias": (beta - mean * scale).astype(np.float32)}


def _stack_trees(trees: list):
    """Equal-shaped nested dicts of arrays → one dict of arrays stacked on a
    new leading axis (the JAX package's `jax.tree.map(np.stack, ...)`)."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def convert_openai_resnet_visual(sd: Mapping[str, Any], cfg: CLIPConfig) -> dict:
    """openai ModifiedResNet `visual.*` keys → the JAX package's ResNet tree
    (BN folded, each stage's tail blocks stacked, `None` for one block)."""
    g = lambda k: _np(sd[k])
    stem = {f"conv{i}": _fold_conv_bn(sd, f"visual.conv{i}", f"visual.bn{i}") for i in (1, 2, 3)}

    def block(prefix: str, down: bool) -> dict:
        p = {f"conv{j}": _fold_conv_bn(sd, f"{prefix}.conv{j}", f"{prefix}.bn{j}") for j in (1, 2, 3)}
        if down:
            p["down"] = _fold_conv_bn(sd, f"{prefix}.downsample.0", f"{prefix}.downsample.1")
        return p

    stages = []
    for si, n_blocks in enumerate(cfg.resnet_layers):
        tails = [block(f"visual.layer{si + 1}.{i}", down=False) for i in range(1, n_blocks)]
        stages.append({"head": block(f"visual.layer{si + 1}.0", down=True),
                       "tail": _stack_trees(tails) if tails else None})
    ap = "visual.attnpool."
    attnpool = {"pos_emb": g(ap + "positional_embedding")}
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("c", "c_proj")):
        attnpool["w" + ours] = g(ap + theirs + ".weight").T
        attnpool["b" + ours] = g(ap + theirs + ".bias")
    return {"stem": stem, "stages": stages, "attnpool": attnpool}


def _openai_text(sd: Mapping[str, Any], cfg: CLIPConfig) -> dict:
    g = lambda k: _np(sd[k])
    return {
        "token_emb": g("token_embedding.weight"),
        "pos_emb": g("positional_embedding"),
        "blocks": _openai_tower(sd, "transformer", cfg.text_layers, cfg.text_width),
        "ln_final": {"scale": g("ln_final.weight"), "bias": g("ln_final.bias")},
        "proj": g("text_projection"),
    }


def openai_tree(sd: Mapping[str, Any], cfg: CLIPConfig) -> dict:
    """openai/open_clip state dict (ViT or ModifiedResNet image tower) → the
    JAX package's param tree."""
    g = lambda k: _np(sd[k])
    text = _openai_text(sd, cfg)
    if "visual.layer1.0.conv1.weight" in sd:
        visual = convert_openai_resnet_visual(sd, cfg)
        return {"visual": visual, "text": text, "logit_scale": g("logit_scale").reshape(())}
    visual = {
        "patch_embed": {"kernel": g("visual.conv1.weight").transpose(2, 3, 1, 0)},
        "class_emb": g("visual.class_embedding").reshape(-1),
        "pos_emb": g("visual.positional_embedding"),
        "ln_pre": {"scale": g("visual.ln_pre.weight"), "bias": g("visual.ln_pre.bias")},
        "blocks": _openai_tower(sd, "visual.transformer", cfg.vision_layers, cfg.vision_width),
        "ln_post": {"scale": g("visual.ln_post.weight"), "bias": g("visual.ln_post.bias")},
        "proj": g("visual.proj"),
    }
    return {"visual": visual, "text": text, "logit_scale": g("logit_scale").reshape(())}


def convert_openai_state_dict(
    sd: Mapping[str, Any], cfg: CLIPConfig, device: str | torch.device = "cuda"
) -> CLIP:
    device = resolve_device(device)
    return from_jax_params(openai_tree(sd, cfg), cfg, device)


# ---------------------------------------------------------------------------
# open_clip EVA02 (timm `Eva` trunk)
# ---------------------------------------------------------------------------

_EVA_TRUNK = "visual.trunk."


def _eva_tower(sd, prefix: str, n_layers: int) -> dict:
    L = prefix + "blocks.{i}."
    stack = lambda name: _stack(sd, L + name, n_layers)  # noqa: E731
    lin = lambda name: stack(name + ".weight").transpose(0, 2, 1)  # noqa: E731  (L, out, in) → (L, in, out)
    ln = lambda name: {"scale": stack(name + ".weight"), "bias": stack(name + ".bias")}  # noqa: E731
    bq = stack("attn.q_proj.bias")
    return {
        "ln_1": ln("norm1"),
        "attn": {"wq": lin("attn.q_proj"), "wk": lin("attn.k_proj"), "wv": lin("attn.v_proj"),
                 "wo": lin("attn.proj"), "bq": bq, "bk": np.zeros_like(bq),  # k's product has no bias
                 "bv": stack("attn.v_proj.bias"), "bo": stack("attn.proj.bias"), "ln": ln("attn.norm")},
        "ln_2": ln("norm2"),
        "mlp": {"w_gate": lin("mlp.fc1_g"), "b_gate": stack("mlp.fc1_g.bias"), "w_in": lin("mlp.fc1_x"),
                "b_in": stack("mlp.fc1_x.bias"), "ln": ln("mlp.norm"), "w_out": lin("mlp.fc2"),
                "b_out": stack("mlp.fc2.bias")},
    }


def eva_tree(sd: Mapping[str, Any], cfg: CLIPConfig) -> dict:
    """open_clip EVA02 state dict → a param tree in the JAX package's layout
    with EVA02's entries (Linear weights (out, in) transposed to x@W, the
    patch convolution to (P, P, 3, W), zeros for k's absent bias)."""
    g = lambda k: _np(sd[k])
    ln = lambda k: {"scale": g(k + ".weight"), "bias": g(k + ".bias")}  # noqa: E731
    t = _EVA_TRUNK
    visual = {
        "patch_embed": {"kernel": g(t + "patch_embed.proj.weight").transpose(2, 3, 1, 0),
                        "bias": g(t + "patch_embed.proj.bias")},
        "class_emb": g(t + "cls_token").reshape(-1),
        "pos_emb": g(t + "pos_embed").reshape(-1, cfg.vision_width),
        "blocks": _eva_tower(sd, t, cfg.vision_layers),
        "ln_post": ln(t + "norm"),
        "proj": g(t + "head.weight").T,
        "proj_bias": g(t + "head.bias"),
    }
    return {"visual": visual, "text": _openai_text(sd, cfg), "logit_scale": g("logit_scale").reshape(())}


def convert_eva_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig, device: str | torch.device = "cuda") -> CLIP:
    """open_clip EVA02 state dict (`visual.trunk.*` plus the text tower's
    keys) → a `CLIP` module of an EVA02 config on `device`."""
    device = resolve_device(device)
    if cfg.vision_mlp != "swiglu" or cfg.rope != "2d":
        raise ValueError(f"{cfg.name} is not an EVA02 config (vision_mlp {cfg.vision_mlp!r}, rope {cfg.rope!r})")
    return from_jax_params(eva_tree(sd, cfg), cfg, device)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def detect_format(sd: Mapping[str, Any]) -> str:
    if "vision_model.head.probe" in sd:
        return "hf_siglip"
    if _EVA_TRUNK + "blocks.0.mlp.fc1_g.weight" in sd:
        return "open_clip_eva"
    if any(k.startswith("vision_model.") for k in sd):
        return "hf"
    if any(k.startswith("visual.") for k in sd):
        return "openai"
    raise ValueError("unrecognized CLIP state dict format")


def convert_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig, device: str | torch.device = "cuda") -> CLIP:
    device = resolve_device(device)
    fmt = detect_format(sd)
    if fmt == "hf_siglip":
        return convert_siglip_state_dict(sd, cfg, device)
    if fmt == "open_clip_eva":
        return convert_eva_state_dict(sd, cfg, device)
    if fmt == "hf":
        return convert_hf_state_dict(sd, cfg, device)
    return convert_openai_state_dict(sd, cfg, device)


def config_from_hf(hf_config) -> CLIPConfig:
    """Build a CLIPConfig from a transformers CLIPConfig."""
    v, t = hf_config.vision_config, hf_config.text_config
    return CLIPConfig(
        name=getattr(hf_config, "name_or_path", "hf") or "hf",
        embed_dim=hf_config.projection_dim,
        image_size=v.image_size,
        patch_size=v.patch_size,
        vision_width=v.hidden_size,
        vision_layers=v.num_hidden_layers,
        vision_heads=v.num_attention_heads,
        vision_mlp_ratio=v.intermediate_size / v.hidden_size,
        vocab_size=t.vocab_size,
        context_length=t.max_position_embeddings,
        text_width=t.hidden_size,
        text_layers=t.num_hidden_layers,
        text_heads=t.num_attention_heads,
        text_mlp_ratio=t.intermediate_size / t.hidden_size,
        act="quick_gelu" if v.hidden_act == "quick_gelu" else "gelu",
        layernorm_eps=v.layer_norm_eps,
    )


def load_checkpoint(
    path: str, cfg: CLIPConfig | None = None, device: str | torch.device = "cuda"
) -> tuple[CLIP, CLIPConfig]:
    """Load a .pt/.bin/.npz checkpoint from disk and convert.

    Returns (model, cfg).  cfg is read from a config.json beside an HF
    checkpoint when not given.  The default device is CUDA; without a GPU it
    raises, before reading the file, unless given "cpu"."""
    import os

    device = resolve_device(device)
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj.state_dict()
    if cfg is None:
        cfg_path = os.path.join(os.path.dirname(path), "config.json")
        if not os.path.exists(cfg_path):
            raise ValueError("cfg required when no config.json is present")
        import json

        from transformers import CLIPConfig as HFCLIPConfig

        with open(cfg_path) as f:
            cfg = config_from_hf(HFCLIPConfig(**json.load(f)))
    return convert_state_dict(sd, cfg, device), cfg

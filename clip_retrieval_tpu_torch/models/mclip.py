"""Multilingual CLIP text encoders (the M-CLIP family) in PyTorch.

Counterpart of `clip_retrieval_tpu/models/mclip.py`.  The reference reaches
these through sentence-transformers (a multilingual DistilBERT + dense
projection) and `multilingual_clip` (XLM-R Large + linear).  Both are a
post-LN BERT-family encoder, masked mean pooling and a linear projection into
the CLIP embedding space, L2-normalized.

The forward keeps the JAX package's details: RoBERTa position ids
`cumsum(mask)·mask + pad_id` (plain 0..n-1 for BERT), the token-type row 0
added when the checkpoint has one, post-LN blocks with exact GELU, a −1e30
mask bias on f32 logits whose softmax is cast to v's dtype, masked mean
pooling in f32, the projection with its optional bias, and L2 in f32.  The
attention is torch ops (the JAX package's einsums, no Pallas kernel).

Weights load from a local directory without `transformers`: `config.json`
is read as JSON, the encoder weights from `model.safetensors` (through
`safetensors.torch`, where installed) or `pytorch_model.bin` (`torch.load`),
the projection from `projection.npz` or a sentence-transformers `2_Dense`
module, and the tokenizer from `tokenizer.json` through the `tokenizers`
library, imported only when the file is there.  Unlike the JAX bundle, the
bundle pads a batch to its longest text and not to a power-of-two bucket:
the buckets only spared XLA compiles, and the masked result does not depend
on the padding.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .clip import Attention, LayerNorm, Mlp, _dense, _param, l2_normalize, matmul_f32
from .loaders import _copy, _np


@dataclasses.dataclass(frozen=True)
class MCLIPConfig:
    vocab_size: int = 250002
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 514
    pad_token_id: int = 1
    position_offset: int = 2  # roberta: positions start at pad_id+1
    out_dim: int = 512  # CLIP embedding dim
    layernorm_eps: float = 1e-5
    act: str = "gelu"


TEST_TINY_MCLIP = MCLIPConfig(
    vocab_size=128,
    hidden=32,
    layers=2,
    heads=4,
    mlp_dim=64,
    max_positions=40,
    out_dim=16,
)


class _Block(nn.Module):
    """Post-LN encoder block (BERT / XLM-R)."""

    def __init__(self, cfg: MCLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg.hidden, device)
        self.ln_attn = LayerNorm(cfg.hidden, device)
        self.mlp = Mlp(cfg.hidden, cfg.mlp_dim, device)
        self.ln_mlp = LayerNorm(cfg.hidden, device)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        cfg, a = self.cfg, self.attn
        b, s, h = x.shape
        dh = h // cfg.heads
        q, k, v = (_dense(x, w, bias).reshape(b, s, cfg.heads, dh)
                   for w, bias in ((a.wq, a.bq), (a.wk, a.bk), (a.wv, a.bv)))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
        probs = torch.softmax(logits + mask_bias[:, None, None, :], dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
        x = self.ln_attn(x + _dense(o.reshape(b, s, h), a.wo, a.bo), cfg.layernorm_eps)
        y = _dense(x, self.mlp.w_in, self.mlp.b_in)
        y = F.gelu(y, approximate="none") if cfg.act == "gelu" else torch.relu(y)
        y = _dense(y, self.mlp.w_out, self.mlp.b_out)
        return self.ln_mlp(x + y, cfg.layernorm_eps)


class MCLIP(nn.Module):
    """The encoder and its projection, with the JAX package's parameter
    names (x@W kernels of shape (in, out)); the blocks reuse the CLIP
    towers' `Attention`, `Mlp` and `LayerNorm` parameter modules."""

    def __init__(self, cfg: MCLIPConfig, type_emb: bool = True, proj_bias: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_emb = _param(cfg.vocab_size, cfg.hidden, device=device)
        self.pos_emb = _param(cfg.max_positions, cfg.hidden, device=device)
        self.type_emb = _param(cfg.hidden, device=device) if type_emb else None
        self.ln_emb = LayerNorm(cfg.hidden, device)
        self.blocks = nn.ModuleList(_Block(cfg, device) for _ in range(cfg.layers))
        self.proj = nn.Module()
        self.proj.w = _param(cfg.hidden, cfg.out_dim, device=device)
        self.proj.b = _param(cfg.out_dim, device=device) if proj_bias else None

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None, *,
               normalize: bool = True, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(B, S) ids → f32 (B, out_dim) CLIP-space embeddings."""
        cfg = self.cfg
        input_ids = input_ids.long()
        if attention_mask is None:
            attention_mask = (input_ids != cfg.pad_token_id).long()
        attention_mask = attention_mask.long()
        mask = attention_mask.float()
        if cfg.position_offset:  # roberta position ids: offset past the pad id
            positions = torch.cumsum(attention_mask, dim=1) * attention_mask + cfg.pad_token_id
        else:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device).expand_as(input_ids)
        x = self.word_emb[input_ids] + self.pos_emb[positions]
        if self.type_emb is not None:  # BERT / XLM-R token-type row 0
            x = x + self.type_emb
        x = self.ln_emb(x.to(compute_dtype), cfg.layernorm_eps)
        mask_bias = torch.where(mask > 0, 0.0, -1e30)
        for blk in self.blocks:
            x = blk(x, mask_bias)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1e-9)
        pooled = (x.float() * mask[:, :, None]).sum(dim=1) / denom
        out = matmul_f32(pooled, self.proj.w)
        if self.proj.b is not None:
            out = out + self.proj.b
        return l2_normalize(out) if normalize else out


def init_mclip(cfg: MCLIPConfig, seed: int = 0, device: str | torch.device = "cuda") -> MCLIP:
    """Random weights with the JAX package's scales: N(0, 1)·0.02 for the
    embeddings, kernels and projection; LayerNorm 1/0 and zero biases.  The
    numbers come from a `torch.Generator` on `device` seeded with `seed`, so
    they differ from the JAX package's for the same seed.  The default
    device is CUDA; without a GPU it raises unless given "cpu"."""
    device = resolve_device(device)
    model = MCLIP(cfg, type_emb=False, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        params = [model.word_emb, model.pos_emb, model.proj.w]
        for blk in model.blocks:
            params += [blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo, blk.mlp.w_in, blk.mlp.w_out]
        for p in params:
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
    return model


def mclip_from_jax_params(tree: Mapping[str, Any], cfg: MCLIPConfig, device: str | torch.device = "cuda") -> MCLIP:
    """The JAX package's M-CLIP param tree (numpy; blocks stacked on a
    leading layer axis) → an `MCLIP` on `device`, weights in f32."""
    device = resolve_device(device)
    model = MCLIP(cfg, type_emb="type_emb" in tree, proj_bias="b" in tree["proj"], device=torch.device("cpu"))
    with torch.no_grad():
        for name in ("word_emb", "pos_emb", "type_emb"):
            if name in tree:
                _copy(getattr(model, name), tree[name], name)
        for leaf in ("scale", "bias"):
            _copy(getattr(model.ln_emb, leaf), tree["ln_emb"][leaf], f"ln_emb.{leaf}")
        bt = tree["blocks"]
        for i, blk in enumerate(model.blocks):
            for sub, names in (("attn", ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")),
                               ("mlp", ("w_in", "b_in", "w_out", "b_out")),
                               ("ln_attn", ("scale", "bias")), ("ln_mlp", ("scale", "bias"))):
                for name in names:
                    _copy(getattr(getattr(blk, sub), name), bt[sub][name][i], f"blocks.{sub}.{name}[{i}]")
        for name in tree["proj"]:
            _copy(getattr(model.proj, name), tree["proj"][name], f"proj.{name}")
    return model.to(device)


def convert_hf_roberta(
    sd: Mapping[str, Any],
    cfg: MCLIPConfig,
    proj_w: np.ndarray,
    proj_b: np.ndarray | None = None,
    prefix: str = "",
    device: str | torch.device = "cuda",
) -> MCLIP:
    """HF XLMRobertaModel / BertModel state dict + projection → `MCLIP`.

    proj_w: (hidden, out_dim) with x @ proj_w semantics (transpose torch's
    (out, in) Linear weight before passing)."""
    device = resolve_device(device)
    g = lambda k: _np(sd[prefix + k])  # noqa: E731
    enc = "encoder.layer.{i}."

    def stack(fmt):
        return np.stack([g(fmt.format(i=i)) for i in range(cfg.layers)])

    def lin_w(fmt):
        return stack(fmt).transpose(0, 2, 1)

    emb = "embeddings."
    tree = {
        "word_emb": g(emb + "word_embeddings.weight"),
        "pos_emb": g(emb + "position_embeddings.weight"),
        "ln_emb": {"scale": g(emb + "LayerNorm.weight"), "bias": g(emb + "LayerNorm.bias")},
        "blocks": {
            "attn": {
                "wq": lin_w(enc + "attention.self.query.weight"),
                "wk": lin_w(enc + "attention.self.key.weight"),
                "wv": lin_w(enc + "attention.self.value.weight"),
                "wo": lin_w(enc + "attention.output.dense.weight"),
                "bq": stack(enc + "attention.self.query.bias"),
                "bk": stack(enc + "attention.self.key.bias"),
                "bv": stack(enc + "attention.self.value.bias"),
                "bo": stack(enc + "attention.output.dense.bias"),
            },
            "ln_attn": {"scale": stack(enc + "attention.output.LayerNorm.weight"),
                        "bias": stack(enc + "attention.output.LayerNorm.bias")},
            "mlp": {
                "w_in": lin_w(enc + "intermediate.dense.weight"),
                "b_in": stack(enc + "intermediate.dense.bias"),
                "w_out": lin_w(enc + "output.dense.weight"),
                "b_out": stack(enc + "output.dense.bias"),
            },
            "ln_mlp": {"scale": stack(enc + "output.LayerNorm.weight"), "bias": stack(enc + "output.LayerNorm.bias")},
        },
        "proj": {"w": np.asarray(proj_w, np.float32)},
    }
    if prefix + emb + "token_type_embeddings.weight" in sd:
        tree["type_emb"] = g(emb + "token_type_embeddings.weight")[0]
    if proj_b is not None:
        tree["proj"]["b"] = np.asarray(proj_b, np.float32)
    return mclip_from_jax_params(tree, cfg, device)


def config_from_hf(hf_config: Mapping[str, Any], out_dim: int) -> MCLIPConfig:
    """An HF encoder's `config.json`, as a dict → MCLIPConfig (HF's
    defaults where a key is missing: pad id 1, LayerNorm eps 1e-12)."""
    pad = hf_config.get("pad_token_id")
    return MCLIPConfig(
        vocab_size=hf_config["vocab_size"],
        hidden=hf_config["hidden_size"],
        layers=hf_config["num_hidden_layers"],
        heads=hf_config["num_attention_heads"],
        mlp_dim=hf_config["intermediate_size"],
        max_positions=hf_config["max_position_embeddings"],
        # explicit None check: `or 1` would clobber BERT's legitimate pad id 0
        pad_token_id=1 if pad is None else pad,
        position_offset=2 if hf_config.get("model_type") in ("roberta", "xlm-roberta") else 0,
        out_dim=out_dim,
        layernorm_eps=hf_config.get("layer_norm_eps", 1e-12),
    )


class MCLIPBundle:
    """A loaded multilingual text encoder and its tokenizer, for the mapper
    and `back`: texts → L2-normalized fp16 numpy (B, out_dim)."""

    def __init__(self, cfg: MCLIPConfig, model: MCLIP, tokenizer=None):
        self.cfg = cfg
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.device = model.word_emb.device

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer loaded for mCLIP")
        encs = [self.tokenizer.encode(t).ids for t in texts]
        max_len = min(max(len(e) for e in encs), self.cfg.max_positions - 2)
        ids = np.full((len(texts), max_len), self.cfg.pad_token_id, np.int64)
        mask = np.zeros((len(texts), max_len), np.int64)
        for i, e in enumerate(encs):
            n = min(len(e), max_len)
            ids[i, :n] = e[:n]
            mask[i, :n] = 1
        with torch.inference_mode():
            out = self.model.encode(torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device))
            return out.half().cpu().numpy()


def _load_projection(model_dir: str):
    """The text→CLIP-space projection, from any of the published layouts:

    - projection.npz           {"w": (hidden, out), "b": (out,)} (our export)
    - 2_Dense/model.safetensors or 2_Dense/pytorch_model.bin   the
      sentence-transformers Dense module: 'linear.weight' (out, in) and
      'linear.bias'.

    Returns (w as (in, out), b or None)."""
    proj_path = os.path.join(model_dir, "projection.npz")
    if os.path.exists(proj_path):
        with np.load(proj_path) as z:
            return z["w"], (z["b"] if "b" in z.files else None)
    dense_dir = os.path.join(model_dir, "2_Dense")
    sd = _read_state_dict(dense_dir, required=False)
    if sd is not None:
        b = sd.get("linear.bias")
        return _np(sd["linear.weight"]).T, (None if b is None else _np(b))
    raise FileNotFoundError(
        f"no projection found in {model_dir}: expected projection.npz or a sentence-transformers 2_Dense module "
        "(pytorch_model.bin / model.safetensors)"
    )


def _read_state_dict(folder: str, required: bool = True):
    """`model.safetensors` (through `safetensors.torch`) or
    `pytorch_model.bin` (`torch.load`) of `folder` → a CPU state dict; None
    (or FileNotFoundError when `required`) when neither file is there."""
    st_path = os.path.join(folder, "model.safetensors")
    bin_path = os.path.join(folder, "pytorch_model.bin")
    if os.path.exists(st_path):
        try:
            import safetensors.torch
        except ImportError:
            if not os.path.exists(bin_path):
                raise ImportError(f"{st_path} needs the safetensors package, which is not installed") from None
        else:
            return safetensors.torch.load_file(st_path)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    if required:
        raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {folder}")
    return None


def load_mclip(model_dir: str, device: str | torch.device = "cuda") -> MCLIPBundle:
    """Load an M-CLIP-style checkpoint from a local directory onto `device`.

    Expected layout (sentence-transformers or M-CLIP export):
      config.json                             HF encoder config
      model.safetensors | pytorch_model.bin   encoder weights
      projection.npz or 2_Dense/              text→CLIP projection
      tokenizer.json                          `tokenizers` file (optional)

    The default device is CUDA; without a GPU it raises before reading."""
    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    proj_w, proj_b = _load_projection(model_dir)
    cfg = config_from_hf(hf_cfg, out_dim=proj_w.shape[1])
    sd = _read_state_dict(model_dir)
    prefix = ""
    if not any(k.startswith("embeddings.") for k in sd):
        for cand in ("roberta.", "bert.", "transformer."):
            if any(k.startswith(cand) for k in sd):
                prefix = cand
                break
    model = convert_hf_roberta(sd, cfg, proj_w, proj_b, prefix=prefix, device=device)
    tokenizer = None
    tok_path = os.path.join(model_dir, "tokenizer.json")
    if os.path.exists(tok_path):
        from tokenizers import Tokenizer

        tokenizer = Tokenizer.from_file(tok_path)
    return MCLIPBundle(cfg, model, tokenizer)

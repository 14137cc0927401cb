"""CLIP in PyTorch: ViT or ResNet image tower + causal text transformer.

Counterpart of `clip_retrieval_tpu/models/clip.py`, with the same parameter
names and layouts (x@W kernels of shape (in, out), the patch kernel as
(P, P, 3, W)), so that `loaders.from_jax_params` copies the JAX tree over
unchanged.  Where JAX scans over weights stacked on a leading layer axis,
each tower here holds an `nn.ModuleList` of `Block`s walked by a Python loop.
A config with `resnet_layers` gets the ModifiedResNet image tower of
`models/resnet.py`; its text tower is the same transformer.

Casting points follow the JAX package: weights are cast to the compute dtype
for each matmul, which accumulates in f32; biases and LayerNorm are applied
in f32, and the result is cast back to the compute dtype.  The projections
return f32 features, and `l2_normalize` works in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops
from ..utils.device import resolve_device
from .configs import CLIPConfig

# CLIP preprocessing constants (openai/open_clip defaults)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, device=device), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, width: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, device=device), requires_grad=False)
        self.bias = _param(width, device=device)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(), self.bias.float(), eps)
        return y.to(x.dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w cast to x's dtype, accumulated and returned in f32
    (JAX's `preferred_element_type=float32`)."""
    w = w.to(x.dtype)
    differentiable = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and x.dtype != torch.float32 and not differentiable:
        # cuBLAS writes the f32 accumulator out without rounding it to x's
        # dtype (an `out_dtype` product; a train step takes the f32 product
        # of the same operands below, which autograd differentiates)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = matmul_f32(x, w)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "gelu":
        return F.gelu(x, approximate="none")
    raise ValueError(f"unknown act {kind}")


class Attention(nn.Module):
    def __init__(self, width: int, device=None):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param(width, width, device=device))
        for name in ("bq", "bk", "bv", "bo"):
            setattr(self, name, _param(width, device=device))


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_dim: int, device=None):
        super().__init__()
        self.w_in = _param(width, mlp_dim, device=device)
        self.b_in = _param(mlp_dim, device=device)
        self.w_out = _param(mlp_dim, width, device=device)
        self.b_out = _param(width, device=device)


class Block(nn.Module):
    """Pre-LN transformer block; attention stays in the packed (B, S, W)
    layout that the projections emit."""

    def __init__(self, width: int, mlp_dim: int, heads: int, act: str, eps: float, causal: bool, device=None):
        super().__init__()
        self.heads, self.act, self.eps, self.causal = heads, act, eps, causal
        self.ln_1 = LayerNorm(width, device)
        self.attn = Attention(width, device)
        self.ln_2 = LayerNorm(width, device)
        self.mlp = Mlp(width, mlp_dim, device)

    def forward(self, x: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        y = self.ln_1(x, self.eps)
        a = self.attn
        q = _dense(y, a.wq, a.bq)
        k = _dense(y, a.wk, a.bk)
        v = _dense(y, a.wv, a.bv)
        o = attn_ops.sdpa_packed(q, k, v, self.heads, causal=self.causal, impl=attn_impl)
        x = x + _dense(o, a.wo, a.bo)
        y = self.ln_2(x, self.eps)
        m = self.mlp
        y = _act(_dense(y, m.w_in, m.b_in), self.act)
        return x + _dense(y, m.w_out, m.b_out)


def _blocks(n: int, width: int, mlp_ratio: float, heads: int, cfg: CLIPConfig, causal: bool, device):
    mlp_dim = int(round(width * mlp_ratio))
    return nn.ModuleList(
        Block(width, mlp_dim, heads, cfg.act, cfg.layernorm_eps, causal, device) for _ in range(n)
    )


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.vision_width
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = _param(cfg.patch_size, cfg.patch_size, 3, w, device=device)
        self.class_emb = _param(w, device=device)
        self.pos_emb = _param(cfg.vision_seq_len, w, device=device)
        self.ln_pre = LayerNorm(w, device)
        self.blocks = _blocks(cfg.vision_layers, w, cfg.vision_mlp_ratio, cfg.vision_heads, cfg, False, device)
        self.ln_post = LayerNorm(w, device)
        self.proj = _param(w, cfg.embed_dim, device=device)

    def forward(self, x: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """x: CLIP-normalized (B, H, W, 3) in the compute dtype → f32
        (B, embed_dim) features, not normalized."""
        cfg = self.cfg
        p_sz, g, w = cfg.patch_size, cfg.grid_size, cfg.vision_width
        b = x.shape[0]
        # im2col patchify: (B, g, P, g, P, 3) → (B, g*g, P*P*3), then one matmul
        x = x.reshape(b, g, p_sz, g, p_sz, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p_sz * p_sz * 3)
        x = matmul_f32(x, self.patch_embed.kernel.reshape(-1, w)).to(x.dtype)
        cls = self.class_emb.to(x.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.pos_emb.to(x.dtype)
        x = self.ln_pre(x, cfg.layernorm_eps)
        for blk in self.blocks:
            x = blk(x, attn_impl)
        x = self.ln_post(x[:, 0], cfg.layernorm_eps)
        return matmul_f32(x, self.proj)


class TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        tw = cfg.text_width
        self.token_emb = _param(cfg.vocab_size, tw, device=device)
        self.pos_emb = _param(cfg.context_length, tw, device=device)
        self.blocks = _blocks(cfg.text_layers, tw, cfg.text_mlp_ratio, cfg.text_heads, cfg, True, device)
        self.ln_final = LayerNorm(tw, device)
        self.proj = _param(tw, cfg.embed_dim, device=device)

    def forward(self, tokens: torch.Tensor, compute_dtype: torch.dtype, attn_impl: str = "auto") -> torch.Tensor:
        """tokens: (B, context_length) integer ids → f32 (B, embed_dim)
        features pooled at the EOT position argmax(tokens)."""
        x = self.token_emb[tokens].to(compute_dtype)
        x = x + self.pos_emb[: x.shape[1]].to(compute_dtype)
        for blk in self.blocks:
            x = blk(x, attn_impl)
        x = self.ln_final(x, self.cfg.layernorm_eps)
        eot = torch.argmax(tokens, dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return matmul_f32(x, self.proj)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.vision_kind == "resnet":
            from .resnet import ResNetVisual

            self.visual = ResNetVisual(cfg, device)
        else:
            self.visual = VisionTransformer(cfg, device)
        self.text = TextTransformer(cfg, device)
        self.logit_scale = nn.Parameter(
            torch.tensor(float(np.log(1 / 0.07)), device=device), requires_grad=False
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_clip(cfg: CLIPConfig, seed: int = 0, device: str | torch.device = "cuda") -> CLIP:
    """Random-init parameters with the JAX package's (openai-style) scales:
    N(0, 1)·width^-½ for attention, MLP-in, patch, class, position and
    projection weights; (2·width)^-½ for MLP-out; 0.02 and 0.01 for the
    text token and position embeddings; LayerNorm 1/0 and zero biases.  A
    ResNet image tower takes `resnet.init_resnet_visual`'s scales.
    Random numbers come from a `torch.Generator` on `device` seeded with
    `seed`, so they differ from the JAX package's for the same seed.  The
    default device is CUDA; without a GPU it raises unless given "cpu"."""
    device = resolve_device(device)
    model = CLIP(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def fill(p: torch.Tensor, scale: float):
        p.copy_(torch.randn(p.shape, generator=gen, device=device) * scale)

    with torch.no_grad():
        v, w = model.visual, cfg.vision_width
        towers = []
        if cfg.vision_kind == "resnet":
            from .resnet import init_resnet_visual

            init_resnet_visual(v, gen)
        else:
            for p in (v.patch_embed.kernel, v.class_emb, v.pos_emb, v.proj):
                fill(p, w ** -0.5)
            towers.append((v.blocks, w))
        t, tw = model.text, cfg.text_width
        fill(t.token_emb, 0.02)
        fill(t.pos_emb, 0.01)
        fill(t.proj, tw ** -0.5)
        for blocks, width in towers + [(t.blocks, tw)]:
            for blk in blocks:
                for p in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo, blk.mlp.w_in):
                    fill(p, width ** -0.5)
                fill(blk.mlp.w_out, (2 * width) ** -0.5)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def normalize_images(images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) or float in [0, 1] → CLIP-normalized `dtype`.

    `encode_image` applies this only to uint8 inputs; float inputs to
    `encode_image` are taken as already normalized."""
    if images.dtype == torch.uint8:
        x = images.to(dtype) / torch.tensor(255.0, dtype=dtype, device=images.device)
    else:
        x = images.to(dtype)
    mean = torch.as_tensor(IMAGE_MEAN, device=images.device).to(dtype)
    std = torch.as_tensor(IMAGE_STD, device=images.device).to(dtype)
    return (x - mean) / std


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return x32 / torch.clamp(n, min=eps)


def encode_image(
    model: CLIP,
    images: torch.Tensor,
    *,
    normalize: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """images: (B, H, W, 3) uint8 or CLIP-normalized float → f32
    (B, embed_dim), L2-normalized unless normalize=False.  The ViT and the
    ResNet tower take the same normalized input (JAX `encode_image`).
    attn_impl: "auto" | "flash" → kernel K1 (no backward); "xla" → the plain
    attention, differentiable (the JAX names; the ResNet tower ignores it)."""
    if images.dtype == torch.uint8:
        x = normalize_images(images, compute_dtype)
    elif images.dtype in (torch.float32, torch.bfloat16):
        x = images.to(compute_dtype)
    else:
        raise TypeError(f"bad image dtype {images.dtype}")
    feats = model.visual(x) if model.cfg.vision_kind == "resnet" else model.visual(x, attn_impl)
    return l2_normalize(feats) if normalize else feats


def encode_text(
    model: CLIP,
    tokens: torch.Tensor,
    *,
    normalize: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """tokens: (B, context_length) int → f32 (B, embed_dim), pooled at
    argmax(tokens) (EOT has the largest id in the CLIP vocab).  attn_impl
    as for `encode_image`."""
    feats = model.text(tokens.long(), compute_dtype, attn_impl)
    return l2_normalize(feats) if normalize else feats


def clip_forward(
    model: CLIP,
    images: torch.Tensor,
    tokens: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint forward: (image features, text features, exp(logit_scale)),
    the features L2-normalized (JAX `clip_forward`)."""
    img = encode_image(model, images, compute_dtype=compute_dtype, attn_impl=attn_impl)
    txt = encode_text(model, tokens, compute_dtype=compute_dtype, attn_impl=attn_impl)
    return img, txt, model.logit_scale.exp()


def count_params(model: nn.Module) -> int:
    """The number of parameter elements (JAX `count_params` over the param
    tree).  A ResNet tower counts what the JAX tree holds: each BatchNorm is
    folded into its convolution's scale and bias at load in both packages,
    and neither keeps the checkpoint's running statistics."""
    return sum(p.numel() for p in model.parameters())

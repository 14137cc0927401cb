"""CLIP in PyTorch: ViT or ResNet image tower + text transformer.

Counterpart of `clip_retrieval_tpu/models/clip.py`, with the same parameter
names and layouts (x@W kernels of shape (in, out), the patch kernel as
(P, P, 3, W)), so that `loaders.from_jax_params` copies the JAX tree over
unchanged.  Where JAX scans over weights stacked on a leading layer axis,
each tower here holds an `nn.ModuleList` of `Block`s walked by a Python loop.
A config with `resnet_layers` gets the ModifiedResNet image tower of
`models/resnet.py`; its text tower is the same transformer.  A SigLIP
config (`configs.py`) drops the class token and `ln_pre`, adds the patch
bias, pools the image with `MapHead` and the text at its last position
through a biased projection, with bidirectional text attention; the JAX
package has no SigLIP, so only `loaders.convert_siglip_state_dict` fills it.
An EVA02 config turns q and k of the image tower's patch rows by 2-D rotary
angles (`rope_table`, a buffer of `VisionTransformer`), normalises the
attention output before its projection (`Attention.ln`), runs the SwiGLU MLP
with its hidden's LayerNorm (`SwiGLU`) and adds a bias after the image
projection; only `loaders.convert_eva_state_dict` fills it.

Casting points follow the JAX package: weights are cast to the compute dtype
for each matmul, which accumulates in f32; biases and LayerNorm are applied
in f32, and the result is cast back to the compute dtype.  The projections
return f32 features, and `l2_normalize` works in f32.  After each product,
bias, cast, activation and residual add run as one pass, and each LayerNorm
as one pass (`ops/block_fused.py`: kernels on CUDA tensors, the eager chain
on CPU tensors); so do the rotation of q and k after their products, and
the SwiGLU gate with its LayerNorm after the gate product, each in f32 from
the accumulator and rounded once.  A call that autograd records (an input
requires grad, as in the train step) takes the eager chain instead.

The dp×tp train step (`parallel/train.py`) runs these same towers on its
slices of the weights.  Each `Block` and the text tower hold a communicator,
`LOCAL` (the identity; no `reduce`) unless the step attaches its own: `copy`
after each LayerNorm, `reduce` on the f32 product of `wo` and `w_out` before
their bias and residual, and `embed` for the text tower's token rows.  A
block counts its heads from the width of its q projection, so a tp slice
runs its own.

A large bf16 dense on CUDA runs its product and epilogue as one kernel
(`block_fused.dense_gemm`, chosen by `block_fused.dense_route`); the f32
product of a tp `reduce` and every other call take the product and the
epilogue's pass.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops
from ..ops import block_fused, flash
from ..utils import trace
from ..utils.device import resolve_device
from .configs import CLIPConfig, port_config

# CLIP preprocessing constants (openai/open_clip defaults)
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
# the kernel libraries the towers launch on CUDA tensors (`ops/cuda_build.py`)
KERNEL_LIBRARIES = (flash.LIBRARY, block_fused.LIBRARY, block_fused.GEMM_LIBRARY)
# the SwiGLU hidden is padded with zero columns to a multiple of this, so that
# the gate product's rows and the hidden's stay 16-byte aligned
GLU_ALIGN = 8
# the im2col rows of the patch embedding lie this many elements apart at
# least (P·P·3 = 588 at P 14 rounded up to 592), so that they stay 16-byte
# aligned and the product can take `block_fused.dense_gemm`
PATCH_ROW_ALIGN = 8


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, device=device), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, width: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, device=device), requires_grad=False)
        self.bias = _param(width, device=device)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        if _differentiable(x, self.scale, self.bias):
            block_fused.record_eager()
            return block_fused.layernorm_reference(x, self.scale, self.bias, eps)
        return block_fused.layernorm(x.contiguous(), self.scale, self.bias, eps)


def _differentiable(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd records this call: the kernels of `ops/block_fused.py`
    have no backward, so such a call takes the eager chain."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w cast to x's dtype, accumulated and returned in f32
    (JAX's `preferred_element_type=float32`)."""
    w = w.to(x.dtype)
    if x.is_cuda and x.dtype != torch.float32 and not _differentiable(x, w):
        # cuBLAS writes the f32 accumulator out without rounding it to x's
        # dtype (an `out_dtype` product; a train step takes the f32 product
        # of the same operands below, which autograd differentiates)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def _dense(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    act: str | None = None,
    residual: torch.Tensor | None = None,
    reduce=None,
) -> torch.Tensor:
    """residual + act(x @ w + b) in x's dtype: the product accumulated in
    f32, the bias added in f32, rounded to x's dtype, the activation and the
    residual (`ops/block_fused.py`).  `block_fused.dense_route` picks the
    route from the tensors: "gemm" runs it all as one kernel
    (`block_fused.dense_gemm`, bf16 calls on CUDA that it takes), "split" the
    f32 product and then one fused pass.  `reduce` (a block's row-parallel
    products) sums the f32 product over tp first."""
    x2, w = x.reshape(-1, x.shape[-1]), w.to(x.dtype)
    n = w.shape[-1]
    res2 = None if residual is None else residual.reshape(-1, n)
    grad = _differentiable(x, w, b, residual)
    if block_fused.dense_route(x2, w, b, res2, reduce=reduce is not None, grad=grad) == "gemm":
        return block_fused.dense_gemm(x2, w, b, act=act, residual=res2).reshape(*x.shape[:-1], n)
    y = matmul_f32(x, w)
    if reduce is not None:
        y = reduce(y)
    if grad:
        block_fused.record_eager()
        return block_fused.dense_epilogue_reference(y, b, act, residual, x.dtype)
    return block_fused.dense_epilogue(y, b, act=act, residual=residual, dtype=x.dtype)


def _rope_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, table: torch.Tensor, prefix: int) -> torch.Tensor:
    """x @ w + b with each head's pairs of the rows from `prefix` on turned by
    `table`'s angles (`block_fused.rope_epilogue`), in x's dtype."""
    acc = matmul_f32(x, w)
    if _differentiable(x, w, b):
        block_fused.record_eager()
        return block_fused.rope_reference(acc, b, table, prefix, x.dtype)
    return block_fused.rope_epilogue(acc, b, table, prefix=prefix, dtype=x.dtype)


class _Local:
    """The towers' tensor-parallel hooks on a rank that holds every weight:
    each is the identity, and `reduce` None, since there is nothing to sum
    (`parallel/train.py::_Comm` has the tp versions)."""

    reduce = None

    @staticmethod
    def copy(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return table[ids]


LOCAL = _Local()


class Attention(nn.Module):
    """q/k/v/out projections; `ln` (EVA02) normalises the attention output
    before `wo`."""

    def __init__(self, width: int, device=None, ln: bool = False):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param(width, width, device=device))
        for name in ("bq", "bk", "bv", "bo"):
            setattr(self, name, _param(width, device=device))
        self.ln = LayerNorm(width, device) if ln else None


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_dim: int, device=None):
        super().__init__()
        self.w_in = _param(width, mlp_dim, device=device)
        self.b_in = _param(mlp_dim, device=device)
        self.w_out = _param(mlp_dim, width, device=device)
        self.b_out = _param(width, device=device)


class SwiGLU(nn.Module):
    """EVA02's MLP: LN(silu(x·Wg + bg) ⊙ (x·Wx + bx))·W_out + b_out, the
    LayerNorm over the hidden's `mlp_dim` columns.

    The gate and the x product run as one product over [Wg | Wx], each
    padded with zero columns to `GLU_ALIGN`; `block_fused.glu_layernorm`
    forms the hidden from its f32 accumulator and writes zeros in the pad
    columns, which meet zero rows of the padded W_out, so every sum is the
    unpadded one."""

    def __init__(self, width: int, mlp_dim: int, device=None):
        super().__init__()
        self.w_gate = _param(width, mlp_dim, device=device)
        self.b_gate = _param(mlp_dim, device=device)
        self.w_in = _param(width, mlp_dim, device=device)
        self.b_in = _param(mlp_dim, device=device)
        self.ln = LayerNorm(mlp_dim, device)
        self.w_out = _param(mlp_dim, width, device=device)
        self.b_out = _param(width, device=device)

    def hidden(self, y: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
        """(the normalised hidden, zero-padded, in y's dtype; W_out padded to match)."""
        h = self.w_in.shape[1]
        pad = -h % GLU_ALIGN
        cols = lambda t: F.pad(t.to(y.dtype), (0, pad))  # noqa: E731
        acc = matmul_f32(y, torch.cat((cols(self.w_gate), cols(self.w_in)), dim=-1))
        bias = torch.cat((F.pad(self.b_gate, (0, pad)), F.pad(self.b_in, (0, pad))))
        w_out = F.pad(self.w_out.to(y.dtype), (0, 0, 0, pad))
        ln = self.ln
        if _differentiable(y, self.w_gate, self.w_in, bias, ln.scale, ln.bias):
            block_fused.record_eager()
            return block_fused.glu_layernorm_reference(acc, bias, ln.scale, ln.bias, eps, y.dtype), w_out
        return block_fused.glu_layernorm(acc, bias, ln.scale, ln.bias, eps, dtype=y.dtype), w_out


class Block(nn.Module):
    """Pre-LN transformer block; attention stays in the packed (B, S, W)
    layout that the projections emit.  `comm` holds the tensor-parallel
    hooks (`LOCAL` unless the train step attaches its own).  An EVA02 image
    block turns q and k by the tower's rotary table, normalises the
    attention output (`attn_ln`) and runs `SwiGLU` (`swiglu`)."""

    def __init__(self, width: int, mlp_dim: int, heads: int, act: str, eps: float, causal: bool, device=None, *,
                 attn_ln: bool = False, swiglu: bool = False):
        super().__init__()
        self.heads, self.act, self.eps, self.causal = heads, act, eps, causal
        self.comm = LOCAL
        self.ln_1 = LayerNorm(width, device)
        self.attn = Attention(width, device, ln=attn_ln)
        self.ln_2 = LayerNorm(width, device)
        self.mlp = SwiGLU(width, mlp_dim, device) if swiglu else Mlp(width, mlp_dim, device)

    def forward(self, x: torch.Tensor, attn_impl: str = "auto", rope: tuple[torch.Tensor, int] | None = None
                ) -> torch.Tensor:
        """x (B, S, W) → (B, S, W); `rope`: (table, prefix) turns q and k of
        the rows from `prefix` on (`rope_table`)."""
        c = self.comm
        y = c.copy(self.ln_1(x, self.eps))
        a = self.attn
        if rope is None:
            q = _dense(y, a.wq, a.bq)
            k = _dense(y, a.wk, a.bk)
        else:
            q = _rope_dense(y, a.wq, a.bq, *rope)
            k = _rope_dense(y, a.wk, a.bk, *rope)
        v = _dense(y, a.wv, a.bv)
        heads = self.heads * q.shape[-1] // x.shape[-1]  # a tp slice's q holds heads/tp whole heads
        o = attn_ops.sdpa_packed(q, k, v, heads, causal=self.causal, impl=attn_impl)
        if a.ln is not None:
            o = a.ln(o, self.eps)
        x = _dense(o, a.wo, a.bo, residual=x, reduce=c.reduce)
        y = c.copy(self.ln_2(x, self.eps))
        m = self.mlp
        if isinstance(m, SwiGLU):
            y, w_out = m.hidden(y, self.eps)
        else:
            y, w_out = _dense(y, m.w_in, m.b_in, act=self.act), m.w_out
        return _dense(y, w_out, m.b_out, residual=x, reduce=c.reduce)


def _mlp_dim(width: int, mlp_ratio: float) -> int:
    return int(round(width * mlp_ratio))


def _blocks(n: int, width: int, mlp_ratio: float, heads: int, cfg: CLIPConfig, eps: float, causal: bool, device,
            **kinds):
    mlp_dim = _mlp_dim(width, mlp_ratio)
    return nn.ModuleList(Block(width, mlp_dim, heads, cfg.act, eps, causal, device, **kinds) for _ in range(n))


def rope_table(grid: int, ref_grid: int, head_dim: int) -> torch.Tensor:
    """EVA02's 2-D rotary angles as (2, grid², head_dim/2) f32, cos then sin,
    patches row-major: with f_j = 10000^(−j/n), n = head_dim/4, and the patch
    at row r and column c placed at t_r = r·ref_grid/grid, t_c =
    c·ref_grid/grid, pair i turns by t_r·f_i for i < n and by t_c·f_{i−n}
    for the others (timm's `RotaryEmbeddingCat`, `in_pixels=False`).
    Computed in float64, rounded once."""
    if head_dim % 4 or ref_grid <= 0:
        raise ValueError(f"2-D rotary angles need a head dim divisible by 4 and a reference grid, got "
                         f"{head_dim} and {ref_grid}")
    n = head_dim // 4
    f = 10000.0 ** (-np.arange(n) / n)
    t = np.arange(grid) * ref_grid / grid
    rows, cols = np.meshgrid(t, t, indexing="ij")
    angles = np.concatenate([rows.reshape(-1, 1) * f, cols.reshape(-1, 1) * f], axis=1)
    return torch.from_numpy(np.stack([np.cos(angles), np.sin(angles)]).astype(np.float32))


class MapHead(nn.Module):
    """SigLIP's multihead attention pooling: a learned probe is the one query
    over every token (q from the probe, k and v from the tokens, biased
    projections, then `out_proj`), and h + MLP(LN(h)) is the feature.

    The probe's row of attention runs as plain products with f32 logits and
    softmax (`attention.sdpa`, impl "xla"): the kernels work in 16-row
    strips, and at one query row would waste 15/16 of their products."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        w = cfg.vision_width
        self.heads, self.act, self.eps = cfg.vision_heads, cfg.act, cfg.layernorm_eps
        self.probe = _param(w, device=device)
        self.attn = Attention(w, device)
        self.ln = LayerNorm(w, device)
        self.mlp = Mlp(w, _mlp_dim(w, cfg.vision_mlp_ratio), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, W) in the compute dtype → f32 (B, W)."""
        b, s, w = x.shape
        a, dh = self.attn, w // self.heads
        q = _dense(self.probe.to(x.dtype).reshape(1, w), a.wq, a.bq)  # the same query for every image
        k = _dense(x, a.wk, a.bk)
        v = _dense(x, a.wv, a.bv)
        split = lambda t: t.reshape(t.shape[0], -1, self.heads, dh).transpose(1, 2)  # noqa: E731
        o = attn_ops.sdpa(split(q).expand(b, -1, -1, -1), split(k), split(v), impl="xla")
        h = _dense(o.reshape(b, w), a.wo, a.bo)
        m = self.mlp
        y = _dense(self.ln(h, self.eps), m.w_in, m.b_in, act=self.act)
        return h.float() + matmul_f32(y, m.w_out) + m.b_out.float()


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.vision_width
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = _param(cfg.patch_size, cfg.patch_size, 3, w, device=device)
        self.patch_embed.bias = _param(w, device=device) if cfg.patch_bias else None
        self.class_emb = _param(w, device=device) if cfg.class_token else None
        self.pos_emb = _param(cfg.vision_seq_len, w, device=device)
        self.ln_pre = LayerNorm(w, device) if cfg.ln_pre else None
        if cfg.vision_mlp not in ("act", "swiglu"):
            raise ValueError(f"unknown vision_mlp {cfg.vision_mlp!r}")
        self.blocks = _blocks(cfg.vision_layers, w, cfg.vision_mlp_ratio, cfg.vision_heads, cfg, cfg.layernorm_eps,
                              False, device, attn_ln=cfg.attn_ln, swiglu=cfg.vision_mlp == "swiglu")
        self.ln_post = LayerNorm(w, device)
        if cfg.pool == "map":
            self.head, self.proj = MapHead(cfg, device), None
        elif cfg.pool == "cls":
            self.head, self.proj = None, _param(w, cfg.embed_dim, device=device)
        else:
            raise ValueError(f"unknown pool {cfg.pool!r}")
        self.proj_bias = _param(cfg.embed_dim, device=device) if cfg.vision_proj_bias else None
        if cfg.rope == "2d":
            table = rope_table(cfg.grid_size, cfg.rope_grid, cfg.vision_head_dim)
            self.register_buffer("rope", table.to(device), persistent=False)
        elif cfg.rope == "none":
            self.rope = None
        else:
            raise ValueError(f"unknown rope {cfg.rope!r}")

    def embed_patches(self, x: torch.Tensor) -> torch.Tensor:
        """The patch convolution, stride P and "valid" (the pixels past the
        last whole patch dropped), as im2col over the top-left g·P pixels:
        (B, H, W, 3) → (B, g, P, g, P, 3) → (B, g·g, P·P·3), then one
        matmul → (B, g·g, width) in x's dtype.  The im2col is written with
        its rows `PATCH_ROW_ALIGN`-aligned (the pad columns never read)."""
        p_sz, g = self.cfg.patch_size, self.cfg.grid_size
        b, k = x.shape[0], p_sz * p_sz * 3
        if x.shape[1:3] != (g * p_sz, g * p_sz):
            x = x[:, : g * p_sz, : g * p_sz]
        cols = x.new_empty(b, g * g, -(-k // PATCH_ROW_ALIGN) * PATCH_ROW_ALIGN)[..., :k]
        cols.view(b, g, g, p_sz, p_sz * 3).copy_(x.reshape(b, g, p_sz, g, p_sz * 3).permute(0, 1, 3, 2, 4))
        return _dense(cols, self.patch_embed.kernel.reshape(-1, self.cfg.vision_width), self.patch_embed.bias)

    def forward(self, x: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """x: normalized (B, H, W, 3) in the compute dtype → f32
        (B, embed_dim) features, not normalized."""
        cfg = self.cfg
        b, w = x.shape[0], cfg.vision_width
        x = self.embed_patches(x)
        if self.class_emb is not None:
            x = torch.cat([self.class_emb.to(x.dtype).expand(b, 1, w), x], dim=1)
        x = x + self.pos_emb.to(x.dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x, cfg.layernorm_eps)
        rope = None if self.rope is None else (self.rope, int(cfg.class_token))
        for blk in self.blocks:
            x = blk(x, attn_impl, rope)
        if self.head is not None:
            with trace.span("visual.head"):
                return self.head(self.ln_post(x, cfg.layernorm_eps))
        x = self.ln_post(x[:, 0], cfg.layernorm_eps)
        y = matmul_f32(x, self.proj)
        return y if self.proj_bias is None else y + self.proj_bias.float()


class TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.comm = LOCAL  # its `embed` looks up the token rows
        tw = cfg.text_width
        self.token_emb = _param(cfg.vocab_size, tw, device=device)
        self.pos_emb = _param(cfg.context_length, tw, device=device)
        self.blocks = _blocks(cfg.text_layers, tw, cfg.text_mlp_ratio, cfg.text_heads, cfg, cfg.text_eps,
                              cfg.text_causal, device)
        self.ln_final = LayerNorm(tw, device)
        self.proj = _param(tw, cfg.embed_dim, device=device)
        self.proj_bias = _param(cfg.embed_dim, device=device) if cfg.text_proj_bias else None
        if cfg.text_pool not in ("eot", "last"):
            raise ValueError(f"unknown text pool {cfg.text_pool!r}")

    def forward(self, tokens: torch.Tensor, compute_dtype: torch.dtype, attn_impl: str = "auto") -> torch.Tensor:
        """tokens: (B, context_length) integer ids → f32 (B, embed_dim)
        features pooled at the EOT position argmax(tokens) (CLIP), or at the
        last position (SigLIP)."""
        x = self.comm.embed(self.token_emb, tokens).to(compute_dtype)
        x = x + self.pos_emb[: x.shape[1]].to(compute_dtype)
        for blk in self.blocks:
            x = blk(x, attn_impl)
        x = self.ln_final(x, self.cfg.text_eps)
        if self.cfg.text_pool == "last":
            x = x[:, -1]
        else:
            eot = torch.argmax(tokens, dim=-1)
            x = x[torch.arange(x.shape[0], device=x.device), eot]
        y = matmul_f32(x, self.proj)
        return y if self.proj_bias is None else y + self.proj_bias.float()


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg = port_config(cfg)
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
    ResNet image tower takes `resnet.init_resnet_visual`'s scales; a
    pooling head's probe and products take the blocks' scales, a SwiGLU
    gate the MLP-in scale.
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
                if p is not None:
                    fill(p, w ** -0.5)
            towers.append((v.blocks, w))
            if v.head is not None:
                fill(v.head.probe, w ** -0.5)
                towers.append(([v.head], w))
        t, tw = model.text, cfg.text_width
        fill(t.token_emb, 0.02)
        fill(t.pos_emb, 0.01)
        fill(t.proj, tw ** -0.5)
        for blocks, width in towers + [(t.blocks, tw)]:
            for blk in blocks:
                for p in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo, blk.mlp.w_in,
                          getattr(blk.mlp, "w_gate", None)):
                    if p is not None:
                        fill(p, width ** -0.5)
                fill(blk.mlp.w_out, (2 * width) ** -0.5)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def normalize_images(
    images: torch.Tensor, dtype: torch.dtype = torch.float32, mean=IMAGE_MEAN, std=IMAGE_STD
) -> torch.Tensor:
    """uint8 (B, H, W, 3) or float in [0, 1] → `dtype` normalized by the
    per-channel `mean` and `std` (CLIP's by default).

    `encode_image` applies this only to uint8 inputs, with the config's
    mean and std; float inputs to `encode_image` are taken as already
    normalized."""
    if images.dtype == torch.uint8:
        x = images.to(dtype) / torch.tensor(255.0, dtype=dtype, device=images.device)
    else:
        x = images.to(dtype)
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=images.device).to(dtype)
    std = torch.as_tensor(np.asarray(std, np.float32), device=images.device).to(dtype)
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
    """images: (B, H, W, 3) uint8 or normalized float → f32
    (B, embed_dim), L2-normalized unless normalize=False.  The ViT and the
    ResNet tower take the same normalized input (JAX `encode_image`).
    attn_impl: "auto" | "flash" → kernel K1 (no backward); "xla" → the plain
    attention, differentiable (the JAX names; the ResNet tower ignores it)."""
    if images.dtype == torch.uint8:
        x = normalize_images(images, compute_dtype, model.cfg.image_mean, model.cfg.image_std)
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
    argmax(tokens) (EOT has the largest id in the CLIP vocab), or at the
    last position for SigLIP.  attn_impl as for `encode_image`."""
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

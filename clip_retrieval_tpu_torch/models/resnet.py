"""CLIP ModifiedResNet image tower (RN50/RN101/RN50x{4,16,64}) in PyTorch.

Counterpart of `clip_retrieval_tpu/models/resnet.py`: the published openai
ModifiedResNet (a 3-conv stem, four bottleneck stages whose stride-2 blocks
downsample with a 2x2 average pool before the conv, and a single-query
attention pool), with BatchNorm folded into a per-channel `scale` and `bias`
after every convolution (`loaders.convert_openai_resnet_visual`).

Module tree (parameter names are the JAX package's; all f32, cast per call):

    stem:     conv1/conv2/conv3 -> Conv {kernel, scale (O,), bias (O,)}
    stages:   4 x Stage {head: Bottleneck, tail: ModuleList of Bottleneck}
              Bottleneck = {conv1, conv2, conv3[, down]} of Convs
    attnpool: {pos_emb (S+1, C), wq, bq, wk, bk, wv, bv, wc, bc}

Layout choices:

- Activations are NHWC, as in the JAX package.  Each convolution is
  `F.conv2d` (cuDNN on the card) on the NCHW view `x.permute(0, 3, 1, 2)`,
  which is `channels_last` in memory, so no transpose is copied.
- `Conv.kernel` is held as OIHW (torch's conv layout), not the JAX tree's
  HWIO: `from_jax_params` and `init_clip` convert it once at load, so no
  forward transposes a kernel.
- The JAX package stacks a stage's identical tail blocks for `lax.scan`;
  here `tail` is a `ModuleList` walked in a Python loop, empty when the
  stage has one block.

Casting points follow the JAX package: a conv's folded `* scale + bias`, its
relu, the 2x2 average pool (a sum times 0.25) and the residual add with its
relu run in f32 and are cast back to the compute dtype; in the attention
pool the mean token is taken in f32, the q/k/v projections stay f32 with
their bias, scores and softmax are f32, and the pooled token is cast to the
compute dtype before `wc`.  One casting point cannot be kept: a bf16
`F.conv2d` accumulates in f32 but rounds its output to bf16 before the f32
epilogue (PyTorch gives a convolution no f32 output type), where XLA hands
the epilogue the f32 accumulator.  In f32 the two are the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .clip import _param, matmul_f32
from .configs import CLIPConfig

_EXPANSION = 4


class Conv(nn.Module):
    """A bias-free convolution with its BatchNorm folded into scale/bias."""

    def __init__(self, kh: int, cin: int, cout: int, device=None):
        super().__init__()
        self.kernel = _param(cout, cin, kh, kh, device=device)  # OIHW
        self.scale = nn.Parameter(torch.ones(cout, device=device), requires_grad=False)
        self.bias = _param(cout, device=device)

    def forward(self, x: torch.Tensor, stride: int = 1, relu: bool = True) -> torch.Tensor:
        """NHWC `x` → NHWC conv (+ folded BN) (+ relu) in x's dtype.  3x3
        kernels take torch's explicit padding 1."""
        pad = (self.kernel.shape[-1] - 1) // 2
        k = self.kernel.to(dtype=x.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2), k, stride=stride, padding=pad)
        y = y.permute(0, 2, 3, 1).float() * self.scale + self.bias
        if relu:
            y = torch.relu(y)
        return y.to(x.dtype)


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of NHWC `x`, summed in f32 (every feature
    map here has even sides)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).float(), 2)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, down: bool, device=None):
        super().__init__()
        self.conv1 = Conv(1, cin, planes, device)
        self.conv2 = Conv(3, planes, planes, device)
        self.conv3 = Conv(1, planes, planes * _EXPANSION, device)
        self.down = Conv(1, cin, planes * _EXPANSION, device) if down else None

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if stride > 1:
            out = _avgpool2(out)
        out = self.conv3(out, relu=False)
        if self.down is not None:
            idn = self.down(_avgpool2(x) if stride > 1 else x, relu=False)
        else:
            idn = x
        return torch.relu(out.float() + idn.float()).to(x.dtype)


class Stage(nn.Module):
    def __init__(self, cin: int, planes: int, n_blocks: int, device=None):
        super().__init__()
        self.head = Bottleneck(cin, planes, True, device)
        cout = planes * _EXPANSION
        self.tail = nn.ModuleList(Bottleneck(cout, planes, False, device) for _ in range(n_blocks - 1))


class AttentionPool(nn.Module):
    def __init__(self, seq: int, c: int, out_dim: int, device=None):
        super().__init__()
        self.pos_emb = _param(seq, c, device=device)
        for name in ("wq", "wk", "wv"):
            setattr(self, name, _param(c, c, device=device))
        for name in ("bq", "bk", "bv"):
            setattr(self, name, _param(c, device=device))
        self.wc = _param(c, out_dim, device=device)
        self.bc = _param(out_dim, device=device)

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        """NHWC (B, h, w, C) in the compute dtype → f32 (B, out_dim)."""
        b, h, w, c = x.shape
        t = x.reshape(b, h * w, c)
        mean = t.float().mean(dim=1, keepdim=True).to(t.dtype)
        t = torch.cat([mean, t], dim=1) + self.pos_emb.to(t.dtype)  # (B, S+1, C), mean token first
        dh = c // heads
        q = (matmul_f32(t[:, :1], self.wq) + self.bq.float()).reshape(b, 1, heads, dh)
        k = (matmul_f32(t, self.wk) + self.bk.float()).reshape(b, -1, heads, dh)
        v = (matmul_f32(t, self.wv) + self.bv.float()).reshape(b, -1, heads, dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        o = o.reshape(b, c).to(x.dtype)
        return matmul_f32(o, self.wc) + self.bc.float()


class ResNetVisual(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        if not cfg.resnet_layers:
            raise ValueError(f"{cfg.name}: ResNetVisual needs resnet_layers")
        self.cfg = cfg
        w = cfg.vision_width
        self.stem = nn.Module()
        self.stem.conv1 = Conv(3, 3, w // 2, device)
        self.stem.conv2 = Conv(3, w // 2, w // 2, device)
        self.stem.conv3 = Conv(3, w // 2, w, device)
        stages, cin = [], w
        for si, n_blocks in enumerate(cfg.resnet_layers):
            planes = w * 2 ** si
            stages.append(Stage(cin, planes, n_blocks, device))
            cin = planes * _EXPANSION
        self.stages = nn.ModuleList(stages)
        self.attnpool = AttentionPool(cfg.grid_size ** 2 + 1, cfg.attnpool_dim, cfg.embed_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: CLIP-normalized (B, H, W, 3) in the compute dtype → f32
        (B, embed_dim) features, not normalized."""
        x = self.stem.conv1(x, stride=2)
        x = self.stem.conv3(self.stem.conv2(x))
        x = _avgpool2(x)
        for si, stage in enumerate(self.stages):
            x = stage.head(x, stride=1 if si == 0 else 2)
            for blk in stage.tail:
                x = blk(x)
        return self.attnpool(x, self.cfg.vision_heads)


def forward_visual(visual: ResNetVisual, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """CLIP-normalized float (B, H, W, 3) → f32 (B, embed_dim), not
    normalized (JAX `resnet.forward_visual`)."""
    return visual(x.to(compute_dtype))


def init_resnet_visual(visual: ResNetVisual, gen: torch.Generator):
    """Fill `visual` in place with the JAX package's scales: conv kernels
    N(0, 1)·(kh·kw·cin)^-½ with scale 1 and bias 0; the attention pool's
    position embedding and q/k/v/c weights N(0, 1)·C^-½, its biases 0."""
    device = visual.attnpool.pos_emb.device

    def fill(p: torch.Tensor, scale: float):
        p.copy_(torch.randn(p.shape, generator=gen, device=device) * scale)

    with torch.no_grad():
        for m in visual.modules():
            if isinstance(m, Conv):
                o, i, kh, kw = m.kernel.shape
                fill(m.kernel, (kh * kw * i) ** -0.5)
        ap, c = visual.attnpool, visual.cfg.attnpool_dim
        for p in (ap.pos_emb, ap.wq, ap.wk, ap.wv, ap.wc):
            fill(p, c ** -0.5)

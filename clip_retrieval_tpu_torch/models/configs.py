"""Model configurations for CLIP towers.

The reference delegates model definition to `all_clip.load_clip`
(rom1504/clip-retrieval `clip_retrieval/clip_inference/mapper.py:4,36`); we define the
architectures natively.  Configs cover the model families the reference's docs
exercise (ViT-B/32, B/16, L/14, H/14, g/14 + the mCLIP text variants handled
separately in loaders) plus the openai ResNet family (RN50, RN101,
RN50x{4,16,64}) the reference reaches through the same `clip_model` string,
SigLIP So400m/14 at 384 px (open_clip's `ViT-SO400M-14-SigLIP-384`),
whose towers depart from CLIP's in the fields marked "SigLIP" below, and
EVA02-CLIP-L/14 at 336 px (open_clip's `EVA02-L-14-336`), whose image tower
departs in the fields marked "EVA02".
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str = "ViT-B/32"
    embed_dim: int = 512

    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp_ratio: float = 4.0

    # ResNet vision tower (openai RN50/RN101/RN50x{4,16,64} family): when
    # resnet_layers is set the image tower is a ModifiedResNet and
    # vision_width is the stem width (64 for RN50); vision_heads is the
    # attention-pool head count; patch_size/vision_layers/mlp_ratio are
    # unused.  The text tower is the same transformer either way.
    resnet_layers: Optional[tuple] = None

    # text tower
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_mlp_ratio: float = 4.0

    # activation: openai checkpoints use quick_gelu; open_clip H/g use gelu;
    # SigLIP uses gelu_tanh (transformers' gelu_pytorch_tanh)
    act: str = "quick_gelu"
    layernorm_eps: float = 1e-5
    # the text tower's LayerNorm eps where it differs from the image tower's
    # (None: layernorm_eps in both)
    text_layernorm_eps: Optional[float] = None

    # SigLIP: the image tower has no class token and no ln_pre, a patch
    # convolution with bias, and pools with the attention-pooling head
    # ("map": ln_post over every token, then a learned probe attends to
    # them; no projection after it) in place of "cls" (ln_post(x[:, 0]) @
    # proj); the text tower is bidirectional, pooled at the last position
    # ("last", in place of "eot" = argmax(tokens)), and its projection
    # carries a bias
    class_token: bool = True
    ln_pre: bool = True
    patch_bias: bool = False
    pool: str = "cls"
    text_causal: bool = True
    text_pool: str = "eot"
    text_proj_bias: bool = False

    # EVA02: the image tower rotates q and k of the patch rows ("2d": the
    # first half of each head's pairs by the patch's row, the second half by
    # its column, positions scaled to a rope_grid × rope_grid reference
    # grid; the class row is not turned), its MLP is SwiGLU with a LayerNorm
    # on its hidden (LN(silu(x·Wg + bg) ⊙ (x·Wx + bx)), hidden =
    # vision_width·vision_mlp_ratio, in place of act(x·W + b)), a LayerNorm
    # sits on the attention output before its projection (attn_ln), and the
    # image projection carries a bias
    rope: str = "none"
    rope_grid: int = 0
    vision_mlp: str = "act"
    attn_ln: bool = False
    vision_proj_bias: bool = False

    # preprocessing: CLIP's mean and std, the shorter side resized then
    # centre-cropped ("crop"); SigLIP normalizes with 0.5 and resizes both
    # sides to image_size ("squash"); "clip" BPE or "siglip" framing tokens
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)
    resize: str = "crop"
    tokenizer: str = "clip"

    @property
    def vision_kind(self) -> str:
        return "resnet" if self.resnet_layers else "vit"

    @property
    def grid_size(self) -> int:
        # ModifiedResNet downsamples 32x total (stem 4x + 3 strided stages);
        # a ViT's "valid" patch convolution drops the pixels past the last
        # whole patch (SigLIP: 384 px at patch 14 → 27)
        if self.resnet_layers:
            return self.image_size // 32
        return self.image_size // self.patch_size

    @property
    def attnpool_dim(self) -> int:
        """Channel width entering the attention pool (stage-4 output)."""
        return self.vision_width * 32  # width*8 planes x expansion 4

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def vision_seq_len(self) -> int:
        return self.num_patches + int(self.class_token)

    @property
    def text_eps(self) -> float:
        return self.layernorm_eps if self.text_layernorm_eps is None else self.text_layernorm_eps

    @property
    def vision_head_dim(self) -> int:
        return self.vision_width // self.vision_heads

    @property
    def text_head_dim(self) -> int:
        return self.text_width // self.text_heads

    def replace(self, **kw) -> "CLIPConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, CLIPConfig] = {}


def _register(cfg: CLIPConfig) -> CLIPConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


VIT_B32 = _register(CLIPConfig(name="ViT-B/32"))
VIT_B16 = _register(CLIPConfig(name="ViT-B/16", patch_size=16))
VIT_L14 = _register(
    CLIPConfig(
        name="ViT-L/14",
        embed_dim=768,
        patch_size=14,
        vision_width=1024,
        vision_layers=24,
        vision_heads=16,
        text_width=768,
        text_layers=12,
        text_heads=12,
    )
)
VIT_L14_336 = _register(VIT_L14.replace(name="ViT-L/14@336px", image_size=336))
VIT_H14 = _register(
    CLIPConfig(
        name="ViT-H/14",
        embed_dim=1024,
        patch_size=14,
        vision_width=1280,
        vision_layers=32,
        vision_heads=16,
        text_width=1024,
        text_layers=24,
        text_heads=16,
        act="gelu",
    )
)
VIT_G14 = _register(
    CLIPConfig(
        name="ViT-g/14",
        embed_dim=1024,
        patch_size=14,
        vision_width=1408,
        vision_layers=40,
        vision_heads=16,
        vision_mlp_ratio=4.3637,
        text_width=1024,
        text_layers=24,
        text_heads=16,
        act="gelu",
    )
)

# openai CLIP ResNet family (the reference accepts these via all_clip, e.g.
# `clip_model="RN50"`; hyperparameters follow the published openai CLIP
# builds — stem width, per-stage block counts, attnpool heads = width/2).
RN50 = _register(
    CLIPConfig(
        name="RN50",
        embed_dim=1024,
        resnet_layers=(3, 4, 6, 3),
        vision_width=64,
        vision_heads=32,
        text_width=512,
        text_heads=8,
    )
)
RN101 = _register(
    CLIPConfig(
        name="RN101",
        embed_dim=512,
        resnet_layers=(3, 4, 23, 3),
        vision_width=64,
        vision_heads=32,
        text_width=512,
        text_heads=8,
    )
)
RN50X4 = _register(
    CLIPConfig(
        name="RN50x4",
        embed_dim=640,
        image_size=288,
        resnet_layers=(4, 6, 10, 6),
        vision_width=80,
        vision_heads=40,
        text_width=640,
        text_heads=10,
    )
)
RN50X16 = _register(
    CLIPConfig(
        name="RN50x16",
        embed_dim=768,
        image_size=384,
        resnet_layers=(6, 8, 18, 8),
        vision_width=96,
        vision_heads=48,
        text_width=768,
        text_heads=12,
    )
)
RN50X64 = _register(
    CLIPConfig(
        name="RN50x64",
        embed_dim=1024,
        image_size=448,
        resnet_layers=(3, 15, 36, 10),
        vision_width=128,
        vision_heads=64,
        text_width=1024,
        text_heads=16,
    )
)

# Tiny config for tests: runs in milliseconds on CPU.
TEST_TINY = _register(
    CLIPConfig(
        name="test-tiny",
        embed_dim=32,
        image_size=32,
        patch_size=8,
        vision_width=48,
        vision_layers=2,
        vision_heads=4,
        # 520 ≥ byte-fallback tokenizer vocab (514) for vocab-file-free tests
        vocab_size=520,
        context_length=16,
        text_width=32,
        text_layers=2,
        text_heads=4,
    )
)


# Tiny ResNet config: stem 3->4->4->8, stages (1,1,1,1), 64px -> 2x2 grid.
TEST_TINY_RN = _register(
    CLIPConfig(
        name="test-tiny-rn",
        embed_dim=16,
        image_size=64,
        resnet_layers=(1, 1, 1, 1),
        vision_width=8,
        vision_heads=4,
        vocab_size=520,
        context_length=16,
        text_width=32,
        text_layers=2,
        text_heads=4,
    )
)


# SigLIP So400m/14 at 384 px (google/siglip-so400m-patch14-384 config.json;
# open_clip `ViT-SO400M-14-SigLIP-384`): 27 + 27 layers of width 1152, 16
# heads of 72, MLP 4304 in both towers, vocabulary 32,000, context 64
SIGLIP_SO400M_14_384 = _register(
    CLIPConfig(
        name="ViT-SO400M-14-SigLIP-384",
        embed_dim=1152,
        image_size=384,
        patch_size=14,
        vision_width=1152,
        vision_layers=27,
        vision_heads=16,
        vision_mlp_ratio=4304 / 1152,
        vocab_size=32000,
        context_length=64,
        text_width=1152,
        text_layers=27,
        text_heads=16,
        text_mlp_ratio=4304 / 1152,
        act="gelu_tanh",
        layernorm_eps=1e-6,
        class_token=False,
        ln_pre=False,
        patch_bias=True,
        pool="map",
        text_causal=False,
        text_pool="last",
        text_proj_bias=True,
        image_mean=(0.5, 0.5, 0.5),
        image_std=(0.5, 0.5, 0.5),
        resize="squash",
        tokenizer="siglip",
    )
)

# Tiny SigLIP for tests: 44 px at patch 8 (a 5 x 5 grid, the last 4 pixel
# rows and columns dropped), head dims 10 and 12, a text width other than
# the embedding's, 260 ≥ the byte-level SigLIP ids (3 + 255 + 1)
TEST_TINY_SIGLIP = _register(
    SIGLIP_SO400M_14_384.replace(
        name="test-tiny-siglip",
        embed_dim=40,
        image_size=44,
        patch_size=8,
        vision_width=40,
        vision_layers=2,
        vision_heads=4,
        vision_mlp_ratio=1.5,
        vocab_size=260,
        context_length=16,
        text_width=24,
        text_layers=2,
        text_heads=2,
        text_mlp_ratio=2.5,
    )
)

# EVA02-CLIP-L/14 at 336 px (open_clip `EVA02-L-14-336`; timm
# `eva02_large_patch14_clip_336`; arXiv:2303.15389, arXiv:2303.11331): 24
# image layers of width 1024, 16 heads of 64, 577 tokens, 2-D rotary
# positions at a 16 × 16 reference grid, a SwiGLU MLP of hidden 2730
# (int(1024 · 8/3)) with its LayerNorm, the attention output's LayerNorm,
# eps 1e-6, no ln_pre, a biased 1024 → 768 head; open_clip's 12 × 768 causal
# text tower with erf GELU and eps 1e-5
EVA02_L14_336 = _register(
    CLIPConfig(
        name="EVA02-L-14-336",
        embed_dim=768,
        image_size=336,
        patch_size=14,
        vision_width=1024,
        vision_layers=24,
        vision_heads=16,
        vision_mlp_ratio=2730 / 1024,
        text_width=768,
        text_layers=12,
        text_heads=12,
        act="gelu",
        layernorm_eps=1e-6,
        text_layernorm_eps=1e-5,
        ln_pre=False,
        patch_bias=True,
        rope="2d",
        rope_grid=16,
        vision_mlp="swiglu",
        attn_ln=True,
        vision_proj_bias=True,
    )
)

# Tiny EVA02 for tests: 40 px at patch 8 (a 5 × 5 grid rotated as on a 3 × 3
# reference grid), head dims 12 (image) and 8 (text), a SwiGLU hidden of 42
# (not a multiple of 8)
TEST_TINY_EVA = _register(
    EVA02_L14_336.replace(
        name="test-tiny-eva",
        embed_dim=24,
        image_size=40,
        patch_size=8,
        vision_width=48,
        vision_layers=2,
        vision_heads=4,
        vision_mlp_ratio=42 / 48,
        rope_grid=3,
        vocab_size=520,
        context_length=16,
        text_width=32,
        text_layers=2,
        text_heads=4,
    )
)


def port_config(cfg) -> CLIPConfig:
    """`cfg` as this package's `CLIPConfig`: a config of the JAX package,
    which has CLIP's fields only, takes the defaults of the SigLIP ones."""
    if isinstance(cfg, CLIPConfig):
        return cfg
    return CLIPConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(CLIPConfig) if hasattr(cfg, f.name)})


def get_config(name: str) -> CLIPConfig:
    """Look up a config by name. Accepts openai-style names (ViT-B/32) and
    hyphen/underscore variants (ViT-B-32, vit_b32)."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    norm = name.replace("_", "-").replace("/", "-").lower()
    for key, cfg in _REGISTRY.items():
        if key.replace("/", "-").lower() == norm:
            return cfg
    raise KeyError(f"unknown CLIP config {name!r}; known: {sorted(_REGISTRY)}")


def list_configs() -> list[str]:
    return sorted(_REGISTRY)

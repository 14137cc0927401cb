"""SigLIP So400m's equations in the port (`test-tiny-siglip`, seeded random
weights, float32 on the CPU), held to the plain reference
`tests/plain_ref/siglip_ref.py`, and the reference held to
`transformers.SiglipModel` on the same state dict.

The port meets the repo's tower bar (cosine ≥ 0.999, atol 2e-4); the
reference meets transformers at atol 1e-5.  Besides: the loader reads every
key of the HF layout, the valid convolution drops the pixels past the last
patch, the squash resize is PIL's, the tokenizer frames as SigLIP does, and
the embedding job (`inference.worker`: reader, staging, mapper, writer)
writes the reference's rows.
"""

from __future__ import annotations

import dataclasses
import io
import os
from pathlib import Path

os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")

import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from clip_retrieval_tpu_torch.inference.worker import worker
from clip_retrieval_tpu_torch.models import clip as tclip
from clip_retrieval_tpu_torch.models import configs, loaders, preprocess, zoo
from clip_retrieval_tpu_torch.models.tokenizer import SiglipTokenizer

from tests.plain_ref import siglip_ref
from tests.test_inference.fixtures import make_files_corpus, make_image

CFG = configs.get_config("test-tiny-siglip")
REF_CFG = dataclasses.asdict(CFG)
ROOT = Path(__file__).resolve().parents[1]


def _hf_config():
    from transformers import SiglipConfig

    mlp = lambda w, r: int(round(w * r))  # noqa: E731
    return SiglipConfig(
        text_config=dict(vocab_size=CFG.vocab_size, hidden_size=CFG.text_width,
                         intermediate_size=mlp(CFG.text_width, CFG.text_mlp_ratio),
                         num_hidden_layers=CFG.text_layers, num_attention_heads=CFG.text_heads,
                         max_position_embeddings=CFG.context_length, layer_norm_eps=CFG.layernorm_eps,
                         projection_size=CFG.embed_dim),
        vision_config=dict(image_size=CFG.image_size, patch_size=CFG.patch_size, hidden_size=CFG.vision_width,
                           intermediate_size=mlp(CFG.vision_width, CFG.vision_mlp_ratio),
                           num_hidden_layers=CFG.vision_layers, num_attention_heads=CFG.vision_heads,
                           layer_norm_eps=CFG.layernorm_eps),
    )


@pytest.fixture(scope="module")
def hf():
    """A tiny `transformers.SiglipModel` with every parameter seeded: weights
    N(0, 0.3²), biases N(0, 0.1²), LayerNorm weights 1 + N(0, 0.1²), so that
    a dropped bias, affine or probe shows."""
    from transformers import SiglipModel

    torch.manual_seed(17)
    model = SiglipModel(_hf_config()).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            ln_w = "norm" in name and name.endswith("weight")
            p.copy_(torch.randn_like(p) * (0.3 if p.dim() > 1 else 0.1) + float(ln_w))
    return model


@pytest.fixture(scope="module")
def sd(hf):
    return {k: v.detach().clone() for k, v in hf.state_dict().items()}


@pytest.fixture(scope="module")
def port(sd):
    return loaders.convert_siglip_state_dict(sd, CFG, "cpu").eval()


def _images(n=3, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, 44, 44, 3), dtype=np.uint8))


CAPTIONS = ["a cat", "a photograph of a mountain lake at dawn", "", "x" * 40]


def _tokens():
    return torch.from_numpy(np.stack([siglip_ref.tokenize(c, CFG.context_length) for c in CAPTIONS]))


def _tower_bar(got: torch.Tensor, ref: torch.Tensor):
    cos = F.cosine_similarity(got.double(), ref.double(), dim=-1)
    assert cos.min().item() >= 0.999, cos
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_port_matches_the_reference(port, sd, tower):
    with torch.no_grad():
        if tower == "image":
            got = tclip.encode_image(port, _images())
            ref = siglip_ref.encode_image(sd, REF_CFG, _images())
        else:
            got = tclip.encode_text(port, _tokens())
            ref = siglip_ref.encode_text(sd, REF_CFG, _tokens())
    _tower_bar(got, ref)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_reference_matches_transformers(hf, sd, tower):
    """transformers' SiglipModel is an implementation of the published
    architecture independent of the reference: the same state dict gives
    the same features to float32 rounding."""
    with torch.no_grad():
        if tower == "image":
            ref = siglip_ref.encode_image(sd, REF_CFG, _images())
            theirs = hf.get_image_features(pixel_values=siglip_ref.normalize_pixels(_images()))
        else:
            ref = siglip_ref.encode_text(sd, REF_CFG, _tokens())
            theirs = hf.get_text_features(input_ids=_tokens().long())
    np.testing.assert_allclose(ref.numpy(), F.normalize(theirs, dim=-1).numpy(), atol=1e-5)


class _Reads(dict):
    """A state dict that notes the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_convert_reads_every_key(sd):
    """Every key of `SiglipModel.state_dict()` lands in the port's module
    (logit_bias, a training-loss term, has no place in it), and each element
    is held once: the port's parameter count is the state dict's."""
    tracked = _Reads(sd)
    model = loaders.convert_siglip_state_dict(tracked, CFG, "cpu")
    assert tracked.read == set(sd) - {"logit_bias"}
    assert tclip.count_params(model) == sum(v.numel() for k, v in sd.items() if k != "logit_bias")
    v = model.visual
    assert v.class_emb is None and v.ln_pre is None and v.proj is None
    np.testing.assert_array_equal(v.head.probe.numpy(), sd["vision_model.head.probe"].reshape(-1).numpy())
    np.testing.assert_array_equal(v.head.attn.wk.numpy(),
                                  sd["vision_model.head.attention.in_proj_weight"][CFG.vision_width:
                                                                                   2 * CFG.vision_width].T.numpy())
    np.testing.assert_array_equal(model.text.proj_bias.numpy(), sd["text_model.head.bias"].numpy())


def test_the_format_is_detected_and_loads_from_a_checkpoint(sd, tmp_path):
    assert loaders.detect_format(sd) == "hf_siglip"
    path = str(tmp_path / "siglip.pt")
    torch.save(sd, path)
    for name in ("test-tiny-siglip", "open_clip:test-tiny-siglip/webli"):
        bundle = zoo.load_model(name, checkpoint=path, device="cpu")
        assert bundle.cfg is CFG and isinstance(bundle.tokenizer, SiglipTokenizer)
        with torch.no_grad():
            _tower_bar(tclip.encode_image(bundle.model, _images()), siglip_ref.encode_image(sd, REF_CFG, _images()))


def test_valid_convolution_drops_the_last_pixels(port, sd):
    """At 44 px and patch 8 the grid is 5 × 5: the patch embedding equals a
    stride-8 "valid" Conv2d with bias, which never reads the last 4 pixel
    rows and columns."""
    assert CFG.image_size % CFG.patch_size and CFG.grid_size == CFG.image_size // CFG.patch_size
    x = torch.randn(2, CFG.image_size, CFG.image_size, 3, generator=torch.Generator().manual_seed(3))
    conv = torch.nn.Conv2d(3, CFG.vision_width, CFG.patch_size, stride=CFG.patch_size, padding="valid")
    with torch.no_grad():
        conv.weight.copy_(sd["vision_model.embeddings.patch_embedding.weight"])
        conv.bias.copy_(sd["vision_model.embeddings.patch_embedding.bias"])
        want = conv(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        got = port.visual.embed_patches(x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        x2 = x.clone()
        x2[:, CFG.grid_size * CFG.patch_size:] = 1e3  # the dropped rows and columns
        x2[:, :, CFG.grid_size * CFG.patch_size:] = -1e3
        np.testing.assert_array_equal(port.visual.embed_patches(x2).numpy(), got.numpy())


def _jpeg(w: int, h: int, seed: int = 4) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


@pytest.mark.parametrize("wh", [(60, 40), (33, 90)])
def test_squash_resize_is_pils_bicubic(wh):
    data = _jpeg(*wh)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB").resize((44, 44), Image.BICUBIC))
    np.testing.assert_array_equal(preprocess.decode_resize_squash(data, 44), want)
    np.testing.assert_array_equal(siglip_ref.preprocess(data, 44), want)
    bundle = zoo.load_model("test-tiny-siglip", device="cpu")
    np.testing.assert_array_equal(bundle.preprocess(data), want)
    # a CLIP config keeps its resize and centre crop
    clip_bundle = zoo.load_model("test-tiny", device="cpu")
    np.testing.assert_array_equal(clip_bundle.preprocess(data), preprocess.decode_resize_center_crop(data, 32))


@pytest.mark.parametrize("caption,body", [
    ("a cat", [3 + b for b in b"a cat"]),
    ("", []),
    ("é", [3 + b for b in "é".encode()]),
    ("y" * 63, [3 + ord("y")] * 63),
    ("z" * 200, [3 + ord("z")] * 63),
])
def test_tokenizer_framing(caption, body):
    """No start token; EOS (1) after the body, cut so EOS stays last; pad 1
    to 64; the reference frames the same way."""
    tok = SiglipTokenizer()(caption, 64)
    assert tok.shape == (1, 64) and tok.dtype == np.int32
    want = np.full(64, 1, np.int32)
    want[: len(body)] = body
    want[len(body)] = 1
    np.testing.assert_array_equal(tok[0], want)
    np.testing.assert_array_equal(siglip_ref.tokenize(caption, 64), want)
    assert tok.max() < SiglipTokenizer.vocab_size <= CFG.vocab_size


def test_embedding_job_writes_the_references_rows(sd, tmp_path):
    """`inference.worker` with `clip_model="test-tiny-siglip"` and a
    checkpoint: FilesReader (forked decode pool) → DeviceStagingReader →
    ClipMapper → NumpyWriter over 60×40 JPEGs, squashed, not cropped.  The
    fp16 rows equal the reference's float32 rows to fp16 rounding (atol
    1e-3: an fp16 value near 0.5 is held to 2.4e-4)."""
    corpus = make_files_corpus(str(tmp_path / "corpus"), n=7)
    ckpt = str(tmp_path / "siglip.pt")
    torch.save(sd, ckpt)
    out = str(tmp_path / "out")
    worker([0], corpus, out, 1, clip_model="test-tiny-siglip", checkpoint=ckpt, batch_size=4,
           num_prepro_workers=2, device="cpu")
    meta = pd.read_parquet(os.path.join(out, "metadata", "metadata_0.parquet"))
    img = np.load(os.path.join(out, "img_emb", "img_emb_0.npy"))
    txt = np.load(os.path.join(out, "text_emb", "text_emb_0.npy"))
    assert img.dtype == np.float16 and img.shape == (7, CFG.embed_dim) == txt.shape
    images = np.stack([siglip_ref.preprocess(Path(p).read_bytes(), CFG.image_size) for p in meta["image_path"]])
    assert not np.array_equal(images[0], preprocess.decode_resize_center_crop(make_image(0), CFG.image_size))
    tokens = np.stack([siglip_ref.tokenize(c, CFG.context_length) for c in meta["caption"]])
    with torch.no_grad():
        ref_img = siglip_ref.encode_image(sd, REF_CFG, torch.from_numpy(images))
        ref_txt = siglip_ref.encode_text(sd, REF_CFG, torch.from_numpy(tokens))
    for got, ref in ((img, ref_img), (txt, ref_txt)):
        got = torch.from_numpy(got.astype(np.float32))
        assert F.cosine_similarity(got.double(), ref.double(), dim=-1).min().item() >= 0.9999
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-3)


def test_benchmark_copy_of_the_reference_is_byte_identical():
    assert (ROOT / "portbench" / "reference" / "siglip_ref.py").read_bytes() == \
        (ROOT / "tests" / "plain_ref" / "siglip_ref.py").read_bytes()


def test_registered_widths_and_clip_defaults():
    """So400m at its published widths; every other registered configuration
    but the EVA02 ones (`tests/test_torch_eva.py`) keeps CLIP's structure
    (the new fields at their defaults)."""
    so = configs.get_config("ViT-SO400M-14-SigLIP-384")
    mlp = lambda w, r: int(round(w * r))  # noqa: E731
    assert (so.grid_size, so.vision_seq_len, so.vision_head_dim, so.text_head_dim) == (27, 729, 72, 72)
    assert mlp(so.vision_width, so.vision_mlp_ratio) == mlp(so.text_width, so.text_mlp_ratio) == 4304
    assert (so.embed_dim, so.layernorm_eps, so.act, so.image_mean, so.image_std) == (
        1152, 1e-6, "gelu_tanh", (0.5,) * 3, (0.5,) * 3)
    defaults = configs.CLIPConfig()
    siglip_fields = ("class_token", "ln_pre", "patch_bias", "pool", "text_causal", "text_pool", "text_proj_bias",
                     "image_mean", "image_std", "resize", "tokenizer")
    for name in configs.list_configs():
        cfg = configs.get_config(name)
        if "siglip" not in name.lower() and "eva" not in name.lower():
            assert all(getattr(cfg, f) == getattr(defaults, f) for f in siglip_fields), name
            assert cfg.vision_seq_len == cfg.num_patches + 1

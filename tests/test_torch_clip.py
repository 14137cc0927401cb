"""Port's CLIP towers against the JAX package on the same weights.

The JAX param tree (as numpy) goes into the port through `from_jax_params`;
the same numpy-seeded images and tokens go through both `encode_image` /
`encode_text` in f32 on the CPU, where the JAX towers use their plain
attention reference.  Bar: atol 2e-4 and min cosine ≥ 0.9999.  Configs: a
narrow one with dh=64 (width 128, 2 heads, 2 layers, 32 px, patch 8) and
`test-tiny`.  The tiny HF CLIPModel of tests/test_models/test_clip_parity.py
also goes through both packages' `convert_hf_state_dict`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_retrieval_tpu.models import clip as jclip
from clip_retrieval_tpu.models import loaders as jloaders
from clip_retrieval_tpu.models.configs import TEST_TINY, CLIPConfig
from clip_retrieval_tpu_torch.models import clip as tclip
from clip_retrieval_tpu_torch.models import loaders as tloaders
from clip_retrieval_tpu_torch.models import zoo as tzoo

ATOL, MIN_COS = 2e-4, 0.9999

NARROW = CLIPConfig(
    name="narrow-dh64",
    embed_dim=64,
    image_size=32,
    patch_size=8,
    vision_width=128,
    vision_layers=2,
    vision_heads=2,
    vocab_size=520,
    context_length=16,
    text_width=128,
    text_layers=2,
    text_heads=2,
)


def _images(cfg, n=4, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)


def _tokens(cfg, n=5, seed=1):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, cfg.context_length), np.int32)
    for i in range(n):
        length = int(rng.integers(3, cfg.context_length - 1))
        toks[i, 0] = cfg.vocab_size - 2  # sot
        toks[i, 1:length] = rng.integers(1, cfg.vocab_size - 3, size=length - 1)
        toks[i, length] = cfg.vocab_size - 1  # eot: the largest id
    return toks


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))).min()


def _assert_close(ours, ref):
    assert _min_cos(ours, ref) >= MIN_COS
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=[NARROW, TEST_TINY], ids=lambda c: c.name)
def pair(request):
    cfg = request.param
    params = jclip.init_clip(cfg, 3)
    return cfg, params, tloaders.from_jax_params(_numpy_tree(params), cfg, device="cpu")


def test_encode_image_matches_jax(pair):
    cfg, params, model = pair
    images = _images(cfg)
    ref = np.asarray(jclip.encode_image(params, cfg, jnp.asarray(images)))
    ours = tclip.encode_image(model, torch.from_numpy(images)).numpy()
    _assert_close(ours, ref)


def test_encode_text_matches_jax(pair):
    cfg, params, model = pair
    tokens = _tokens(cfg)
    ref = np.asarray(jclip.encode_text(params, cfg, jnp.asarray(tokens)))
    ours = tclip.encode_text(model, torch.from_numpy(tokens)).numpy()
    _assert_close(ours, ref)


def test_unnormalized_features_match_jax(pair):
    cfg, params, model = pair
    images = _images(cfg, seed=5)
    ref = np.asarray(jclip.encode_image(params, cfg, jnp.asarray(images), normalize=False))
    ours = tclip.encode_image(model, torch.from_numpy(images), normalize=False).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=1e-4)


def test_normalize_images_matches_jax():
    images = _images(NARROW, n=2, seed=7)
    ref = np.asarray(jclip.normalize_images(jnp.asarray(images)))
    np.testing.assert_allclose(tclip.normalize_images(torch.from_numpy(images)).numpy(), ref, atol=1e-6)


def test_bf16_close_to_fp32():
    cfg = NARROW
    model = tclip.init_clip(cfg, 0, device="cpu")
    images = torch.from_numpy(_images(cfg, n=2))
    f32 = tclip.encode_image(model, images).numpy()
    bf16 = tclip.encode_image(model, images, compute_dtype=torch.bfloat16).numpy()
    assert _min_cos(f32, bf16) > 0.99


def test_init_clip_scales_and_determinism():
    cfg = NARROW
    a, b = tclip.init_clip(cfg, 4, device="cpu"), tclip.init_clip(cfg, 4, device="cpu")
    for (name, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), name
    blk = a.visual.blocks[0]
    assert abs(blk.attn.wq.std().item() - cfg.vision_width ** -0.5) < 0.01
    assert abs(blk.mlp.w_out.std().item() - (2 * cfg.vision_width) ** -0.5) < 0.01
    assert abs(a.text.token_emb.std().item() - 0.02) < 0.002
    assert torch.equal(blk.ln_1.scale, torch.ones(cfg.vision_width))
    assert not torch.equal(tclip.init_clip(cfg, 5, device="cpu").visual.proj, a.visual.proj)


def test_zoo_random_model_is_init_seed0():
    bundle = tzoo.load_model("test-tiny", device="cpu")
    ref = tclip.init_clip(TEST_TINY, 0, device="cpu")
    assert torch.equal(bundle.model.visual.proj, ref.visual.proj)
    toks = bundle.tokenize(["a caption"])
    assert toks.shape == (1, TEST_TINY.context_length) and toks.dtype == np.int32


# ---------------------------------------------------------------------------
# the tiny HF CLIPModel through both packages' converters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPConfig(
        projection_dim=32,
        text_config={
            "vocab_size": 64,
            "hidden_size": 32,
            "intermediate_size": 64,
            "num_hidden_layers": 2,
            "num_attention_heads": 4,
            "max_position_embeddings": 16,
            "hidden_act": "quick_gelu",
            "eos_token_id": 63,
            "bos_token_id": 62,
        },
        vision_config={
            "hidden_size": 48,
            "intermediate_size": 96,
            "num_hidden_layers": 2,
            "num_attention_heads": 4,
            "image_size": 32,
            "patch_size": 8,
            "hidden_act": "quick_gelu",
        },
    )
    torch.manual_seed(0)
    return transformers.CLIPModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_converted(hf_model):
    cfg = tloaders.config_from_hf(hf_model.config)
    sd = hf_model.state_dict()
    return cfg, jloaders.convert_hf_state_dict(sd, cfg), tloaders.convert_hf_state_dict(sd, cfg, device="cpu")


def test_hf_conversion_image_matches_jax_and_hf(hf_model, hf_converted):
    cfg, params, model = hf_converted
    images = _images(cfg)
    ref = np.asarray(jclip.encode_image(params, cfg, jnp.asarray(images)))
    ours = tclip.encode_image(model, torch.from_numpy(images)).numpy()
    _assert_close(ours, ref)
    x = (images.astype(np.float32) / 255.0 - tclip.IMAGE_MEAN) / tclip.IMAGE_STD
    with torch.no_grad():
        hf = hf_model.get_image_features(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2)))
    hf = torch.as_tensor(getattr(hf, "pooler_output", hf)).numpy()
    _assert_close(ours, hf / np.linalg.norm(hf, axis=-1, keepdims=True))


def test_hf_conversion_text_matches_jax_and_hf(hf_model, hf_converted):
    cfg, params, model = hf_converted
    tokens = _tokens(cfg)
    ref = np.asarray(jclip.encode_text(params, cfg, jnp.asarray(tokens)))
    ours = tclip.encode_text(model, torch.from_numpy(tokens)).numpy()
    _assert_close(ours, ref)
    with torch.no_grad():
        hf = hf_model.get_text_features(input_ids=torch.from_numpy(tokens).long())
    hf = torch.as_tensor(getattr(hf, "pooler_output", hf)).numpy()
    _assert_close(ours, hf / np.linalg.norm(hf, axis=-1, keepdims=True))


def test_openai_conversion_matches_hf(hf_model, hf_converted):
    """An openai-naming state dict built from the same HF weights converts
    to the same modules."""
    cfg, _, model_hf = hf_converted
    sd = hf_model.state_dict()
    osd = {
        "visual.conv1.weight": sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding": sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding": sd["vision_model.embeddings.position_embedding.weight"],
        "visual.ln_pre.weight": sd["vision_model.pre_layrnorm.weight"],
        "visual.ln_pre.bias": sd["vision_model.pre_layrnorm.bias"],
        "visual.ln_post.weight": sd["vision_model.post_layernorm.weight"],
        "visual.ln_post.bias": sd["vision_model.post_layernorm.bias"],
        "visual.proj": sd["visual_projection.weight"].T,
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].T,
        "logit_scale": sd["logit_scale"],
    }
    for tower, prefix, n in (("vision_model", "visual.transformer", cfg.vision_layers),
                             ("text_model", "transformer", cfg.text_layers)):
        for i in range(n):
            src, dst = f"{tower}.encoder.layers.{i}.", f"{prefix}.resblocks.{i}."
            for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"), ("attn.out_proj", "self_attn.out_proj"),
                         ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                osd[dst + a + ".weight"] = sd[src + b + ".weight"]
                osd[dst + a + ".bias"] = sd[src + b + ".bias"]
            for kind in ("weight", "bias"):
                osd[dst + f"attn.in_proj_{kind}"] = torch.cat(
                    [sd[src + f"self_attn.{p}_proj.{kind}"] for p in "qkv"]
                )
    assert tloaders.detect_format(osd) == "openai"
    model_oa = tloaders.convert_openai_state_dict(osd, cfg, device="cpu")
    for (name, a), (_, b) in zip(model_hf.state_dict().items(), model_oa.state_dict().items()):
        assert torch.equal(a, b), name


def test_load_checkpoint_pt_matches_conversion(hf_model, hf_converted, tmp_path):
    cfg, _, model = hf_converted
    path = str(tmp_path / "ckpt.pt")
    torch.save(hf_model.state_dict(), path)
    loaded, cfg2 = tloaders.load_checkpoint(path, cfg, device="cpu")
    assert cfg2 == cfg
    for (name, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), name

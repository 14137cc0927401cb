"""Port's `convert` and `convert.nsfw_keras` against the JAX package's.

`convert` runs on tiny checkpoints of every layout the loaders take (HF ViT,
openai ViT, openai ModifiedResNet, the latter also in bf16): the npz arrays
must equal those the JAX `convert` writes, validation must pass in both, and
the npz must load through both packages' `load_checkpoint` to the same
embeddings (cosine ≥ 0.9999, atol 2e-4).  `convert_keras_nsfw` runs on the
tiny SavedModels of tests/test_models/test_published_weights.py and must
write the JAX package's npz and agree with TF's own output, and
`load_safety_model` converts the reference's cache layout on the fly.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_retrieval_tpu.models import clip as jclip
from clip_retrieval_tpu.models import loaders as jloaders
from clip_retrieval_tpu.models.configs import get_config
from clip_retrieval_tpu.models.convert import convert as jax_convert
from clip_retrieval_tpu.models.convert import convert_keras_nsfw as jax_convert_keras
from clip_retrieval_tpu_torch import cli
from clip_retrieval_tpu_torch.models import clip as tclip
from clip_retrieval_tpu_torch.models import loaders as tloaders
from clip_retrieval_tpu_torch.models import safety as tsafety
from clip_retrieval_tpu_torch.models.convert import convert, convert_keras_nsfw, keras_nsfw_weights

from tests.test_models.test_published_weights import _make_savedmodel
from tests.test_torch_pipeline import checkpoint  # noqa: F401  (module fixture)
from tests.test_torch_resnet import full_rn_state_dict

ATOL, MIN_COS = 2e-4, 0.9999


def _openai_vit_sd(sd: dict, n_vision: int, n_text: int) -> dict:
    """An HF CLIPModel state dict in the openai key layout."""
    out = {
        "visual.conv1.weight": sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding": sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding": sd["vision_model.embeddings.position_embedding.weight"],
        "visual.ln_pre.weight": sd["vision_model.pre_layrnorm.weight"],
        "visual.ln_pre.bias": sd["vision_model.pre_layrnorm.bias"],
        "visual.ln_post.weight": sd["vision_model.post_layernorm.weight"],
        "visual.ln_post.bias": sd["vision_model.post_layernorm.bias"],
        "visual.proj": sd["visual_projection.weight"].T.contiguous(),
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].T.contiguous(),
        "logit_scale": sd["logit_scale"],
    }
    for tower, prefix, n in (("vision_model", "visual.transformer", n_vision), ("text_model", "transformer", n_text)):
        for i in range(n):
            src, dst = f"{tower}.encoder.layers.{i}.", f"{prefix}.resblocks.{i}."
            for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"), ("attn.out_proj", "self_attn.out_proj"),
                         ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                out[dst + a + ".weight"] = sd[src + b + ".weight"]
                out[dst + a + ".bias"] = sd[src + b + ".bias"]
            for kind in ("weight", "bias"):
                out[dst + f"attn.in_proj_{kind}"] = torch.cat([sd[src + f"self_attn.{p}_proj.{kind}"] for p in "qkv"])
    return out


@pytest.fixture(scope="module")
def checkpoints(checkpoint, tmp_path_factory):  # noqa: F811
    """layout → (.pt path, clip_model)."""
    root = tmp_path_factory.mktemp("convert")
    hf_path, _ = checkpoint
    hf_sd = torch.load(hf_path, map_location="cpu", weights_only=True)
    rn = full_rn_state_dict(get_config("test-tiny-rn"))
    files = {"hf_vit": (hf_path, "test-tiny")}
    for name, sd, model in (("openai_vit", _openai_vit_sd(hf_sd, 2, 2), "test-tiny"), ("openai_rn", rn, "test-tiny-rn"),
                            ("openai_rn_bf16", {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                                                for k, v in rn.items()}, "test-tiny-rn")):
        path = str(root / f"{name}.pt")
        torch.save({"state_dict": sd} if name == "openai_rn" else sd, path)
        files[name] = (path, model)
    return files


@pytest.mark.parametrize("layout", ["hf_vit", "openai_vit", "openai_rn", "openai_rn_bf16"])
def test_convert_writes_the_jax_npz_and_validates(checkpoints, layout, tmp_path, capsys):
    path, clip_model = checkpoints[layout]
    ours = convert(path, str(tmp_path / "ours"), clip_model=clip_model, device="cpu")
    printed = capsys.readouterr().out
    want = jax_convert(path, str(tmp_path / "jax.npz"), clip_model=clip_model)
    jax_printed = capsys.readouterr().out
    assert ours == str(tmp_path / "ours.npz")
    with np.load(ours) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    count = re.compile(r"validated against \S+: ([\d.]+)M params")
    assert count.search(printed).group(1) == count.search(jax_printed).group(1)

    cfg = get_config(clip_model)
    model, _ = tloaders.load_checkpoint(ours, cfg, device="cpu")
    params, _ = jloaders.load_checkpoint(want, cfg)
    imgs = np.random.default_rng(0).integers(0, 256, (2, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    with torch.no_grad():
        got = tclip.encode_image(model, torch.from_numpy(imgs)).numpy()
    ref = np.asarray(jclip.encode_image(params, cfg, jnp.asarray(imgs)))
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= MIN_COS
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_convert_through_the_cli(checkpoints, tmp_path, capsys):
    path, clip_model = checkpoints["openai_rn"]
    cli.main(["convert", "--checkpoint", path, "--output", str(tmp_path / "rn.npz"), "--clip_model", clip_model,
              "--device", "cpu"])
    assert "validated against test-tiny-rn" in capsys.readouterr().out
    assert (tmp_path / "rn.npz").exists()


def test_convert_default_device_raises_before_work(checkpoints, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        convert(checkpoints["openai_rn"][0], str(tmp_path / "out.npz"), clip_model="test-tiny-rn")
    assert not list(tmp_path.iterdir())


# -- the autokeras NSFW heads ---------------------------------------------------


def _npz_equal(a_path, b_path):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("out_dim,zipped", [(1, False), (5, False), (1, True)], ids=["binary", "softmax", "zip"])
def test_convert_keras_nsfw_matches_jax_and_tf(tmp_path, out_dim, zipped):
    pytest.importorskip("tensorflow")
    name = "clip_autokeras_binary_nsfw" if out_dim == 1 else "clip_autokeras_nsfw_b32"
    model = _make_savedmodel(tmp_path / "sm" / name, out_dim=out_dim, seed=out_dim)
    src = str(tmp_path / "sm" / name)
    if zipped:
        import shutil

        src = shutil.make_archive(str(tmp_path / name), "zip", root_dir=str(tmp_path / "sm"))
    ours = convert_keras_nsfw(src, str(tmp_path / "ours.npz"))
    want = jax_convert_keras(src, str(tmp_path / "jax.npz"))
    _npz_equal(ours, want)
    mlp = tsafety.load_mlp_npz(ours, device="cpu")
    assert mlp.final_activation == ("sigmoid" if out_dim == 1 else "softmax") and mlp.skip == 1
    x = np.random.default_rng(1).normal(size=(7, 16)).astype(np.float32)
    np.testing.assert_allclose(mlp.predict(x), model.predict(x, verbose=0), rtol=1e-4, atol=1e-5)
    weights, final_act = keras_nsfw_weights(str(tmp_path / "sm" / name))
    assert final_act == mlp.final_activation and len(weights) == 2


def test_convert_nsfw_keras_through_the_cli(tmp_path, capsys):
    pytest.importorskip("tensorflow")
    _make_savedmodel(tmp_path / "sm", in_dim=8)
    cli.main(["convert.nsfw_keras", "--model_path", str(tmp_path / "sm"), "--output", str(tmp_path / "m.npz")])
    assert "wrote 2-layer MLP (final=sigmoid)" in capsys.readouterr().out
    assert tsafety.load_mlp_npz(str(tmp_path / "m.npz"), device="cpu").weights[0][0].shape == (8, 8)


def test_load_safety_model_converts_the_reference_cache_layout(tmp_path, monkeypatch):
    """~/.cache/clip_retrieval/ViT-L_14/clip_autokeras_binary_nsfw/, as the
    reference leaves it: converted on the fly, cached as npz, the same MLP
    on the next load."""
    pytest.importorskip("tensorflow")
    monkeypatch.setenv("HOME", str(tmp_path))
    sm_dir = tmp_path / ".cache" / "clip_retrieval" / "ViT-L_14" / "clip_autokeras_binary_nsfw"
    sm_dir.parent.mkdir(parents=True)
    model = _make_savedmodel(sm_dir, in_dim=24)
    mlp = tsafety.load_safety_model("ViT-L/14", device="cpu")
    assert mlp is not None and mlp.device.type == "cpu"
    x = np.random.default_rng(4).normal(size=(3, 24)).astype(np.float32)
    np.testing.assert_allclose(mlp.predict(x), model.predict(x, verbose=0), rtol=1e-4, atol=1e-5)
    npz = tmp_path / ".cache" / "clip_retrieval_tpu" / "ViT-L_14" / "nsfw_mlp.npz"
    assert npz.exists()
    np.testing.assert_allclose(tsafety.load_mlp_npz(str(npz), device="cpu").predict(x), mlp.predict(x), atol=1e-6)
    os.remove(npz)
    from clip_retrieval_tpu.models import safety as jsafety

    jax_mlp = jsafety.load_safety_model("ViT-L/14")
    np.testing.assert_allclose(jax_mlp.predict(x, 3), mlp.predict(x), rtol=1e-5, atol=1e-6)


def test_load_safety_model_without_tensorflow_serves_without_the_head(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    (tmp_path / ".cache" / "clip_retrieval_tpu" / "ViT-B_32" / "clip_autokeras_nsfw_b32").mkdir(parents=True)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    assert tsafety.load_safety_model("ViT-B/32", device="cpu") is None
    out = capsys.readouterr().out
    assert "failed to convert keras NSFW model" in out and "use_safety_model requests will be ignored" in out
    assert tsafety._keras_nsfw_dir("ViT-H/14") is None

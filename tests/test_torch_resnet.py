"""Port's ModifiedResNet image tower (RN50…RN50x64) against the JAX package.

The JAX param tree (numpy) goes into the port through `from_jax_params`,
and the same numpy-seeded inputs go through both packages' `forward_visual`
in f32 on the CPU; the openai torch `_ModifiedResNet` of
tests/test_models/test_resnet.py (random weights and BN running stats) goes
through both packages' converters.  Bar: min cosine ≥ 0.9999 and atol 2e-4
(tests/test_models/test_resnet.py:242-243).  Every published RN config is
built on the meta device, so RN50x64's 420M image-tower parameters are never
allocated, and held to the JAX tree's shapes from `jax.eval_shape`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_retrieval_tpu.models import clip as jclip
from clip_retrieval_tpu.models import loaders as jloaders
from clip_retrieval_tpu.models import resnet as jresnet
from clip_retrieval_tpu.models.configs import TEST_TINY_RN
from clip_retrieval_tpu_torch.models import clip as tclip
from clip_retrieval_tpu_torch.models import loaders as tloaders
from clip_retrieval_tpu_torch.models import resnet as tresnet
from clip_retrieval_tpu_torch.models.configs import get_config

from tests.test_models.test_resnet import TINY2, _ModifiedResNet, _randomize

ATOL, MIN_COS = 2e-4, 0.9999
RN_CONFIGS = ["RN50", "RN101", "RN50x4", "RN50x16", "RN50x64"]


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))).min()


def _assert_close(ours, ref):
    assert ours.shape == ref.shape
    assert _min_cos(ours, ref) >= MIN_COS
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def _inputs(cfg, n=4, seed=2):
    return np.random.default_rng(seed).standard_normal((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def _port_visual(visual, x):
    with torch.no_grad():
        return tresnet.forward_visual(visual, torch.from_numpy(x), torch.float32).numpy()


@pytest.fixture(scope="module", params=[TEST_TINY_RN, TINY2], ids=lambda c: c.name)
def pair(request):
    cfg = request.param
    params = jclip.init_clip(cfg, 3)
    return cfg, params, tloaders.from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")


def test_forward_visual_matches_jax(pair):
    cfg, params, model = pair
    x = _inputs(cfg)
    ref = np.asarray(jresnet.forward_visual(params["visual"], cfg, jnp.asarray(x), jnp.float32))
    _assert_close(_port_visual(model.visual, x), ref)


def test_encode_image_and_text_match_jax(pair):
    cfg, params, model = pair
    imgs = np.random.default_rng(5).integers(0, 256, (3, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    toks = np.random.default_rng(6).integers(1, 500, (3, cfg.context_length)).astype(np.int32)
    with torch.no_grad():
        img = tclip.encode_image(model, torch.from_numpy(imgs)).numpy()
        txt = tclip.encode_text(model, torch.from_numpy(toks)).numpy()
    _assert_close(img, np.asarray(jclip.encode_image(params, cfg, jnp.asarray(imgs))))
    _assert_close(txt, np.asarray(jclip.encode_text(params, cfg, jnp.asarray(toks))))


def test_tail_is_a_module_list_empty_for_one_block(pair):
    cfg, params, model = pair
    for stage, n_blocks, jstage in zip(model.visual.stages, cfg.resnet_layers, params["visual"]["stages"]):
        assert len(stage.tail) == n_blocks - 1
        assert (jstage["tail"] is None) == (n_blocks == 1)
        assert stage.head.down is not None and all(blk.down is None for blk in stage.tail)


@pytest.mark.parametrize("cfg", [TEST_TINY_RN, TINY2], ids=lambda c: c.name)
def test_openai_torch_resnet_through_both_converters(cfg):
    """The openai torch ModifiedResNet (random weights and BN stats) →
    `convert_openai_state_dict`: the port's tower equals the torch model's
    output, and the folded tree equals the JAX package's."""
    tmodel = _randomize(_ModifiedResNet(cfg.resnet_layers, cfg.vision_width, cfg.image_size, cfg.vision_heads,
                                        cfg.embed_dim))
    sd = {"visual." + k: v for k, v in tmodel.state_dict().items()}
    ours_tree = tloaders.convert_openai_resnet_visual(sd, cfg)
    jax_tree = jloaders.convert_openai_resnet_visual(sd, cfg)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ours_tree),
                                 jax.tree_util.tree_leaves_with_path(jax_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))
    x = _inputs(cfg)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    model = tloaders.convert_openai_state_dict({**sd, **_text_sd(cfg)}, cfg, device="cpu")
    ours = _port_visual(model.visual, x)
    _assert_close(ours, ref)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=ATOL)


def _text_sd(cfg, seed=4):
    """A minimal openai-layout text tower (tests/test_models/test_resnet.py)."""
    g = torch.Generator().manual_seed(seed)
    tw = cfg.text_width
    sd = {"token_embedding.weight": torch.randn(cfg.vocab_size, tw, generator=g),
          "positional_embedding": torch.randn(cfg.context_length, tw, generator=g)}
    for i in range(cfg.text_layers):
        p = f"transformer.resblocks.{i}."
        sd[p + "attn.in_proj_weight"] = torch.randn(3 * tw, tw, generator=g) * tw ** -0.5
        sd[p + "attn.in_proj_bias"] = torch.randn(3 * tw, generator=g) * 0.1
        sd[p + "attn.out_proj.weight"] = torch.randn(tw, tw, generator=g) * tw ** -0.5
        sd[p + "attn.out_proj.bias"] = torch.randn(tw, generator=g) * 0.1
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = torch.ones(tw)
            sd[p + ln + ".bias"] = torch.zeros(tw)
        sd[p + "mlp.c_fc.weight"] = torch.randn(4 * tw, tw, generator=g) * tw ** -0.5
        sd[p + "mlp.c_fc.bias"] = torch.randn(4 * tw, generator=g) * 0.1
        sd[p + "mlp.c_proj.weight"] = torch.randn(tw, 4 * tw, generator=g) * (4 * tw) ** -0.5
        sd[p + "mlp.c_proj.bias"] = torch.randn(tw, generator=g) * 0.1
    sd["ln_final.weight"] = torch.ones(tw)
    sd["ln_final.bias"] = torch.zeros(tw)
    sd["text_projection"] = torch.randn(tw, cfg.embed_dim, generator=g) * tw ** -0.5
    sd["logit_scale"] = torch.tensor(2.6593)
    return sd


def full_rn_state_dict(cfg, seed=3) -> dict:
    """A whole openai RN CLIP state dict: the torch ModifiedResNet with random
    weights and BN running stats, plus an openai-layout text tower."""
    tmodel = _randomize(_ModifiedResNet(cfg.resnet_layers, cfg.vision_width, cfg.image_size, cfg.vision_heads,
                                        cfg.embed_dim), seed=seed)
    return {**{"visual." + k: v for k, v in tmodel.state_dict().items()}, **_text_sd(cfg, seed + 1)}


def test_full_state_dict_through_both_convert_state_dict():
    cfg = TINY2
    sd = full_rn_state_dict(cfg)
    params = jloaders.convert_state_dict(sd, cfg)
    model = tloaders.convert_state_dict(sd, cfg, device="cpu")
    imgs = np.random.default_rng(5).integers(0, 256, (2, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    toks = np.random.default_rng(6).integers(1, 500, (2, cfg.context_length)).astype(np.int32)
    with torch.no_grad():
        img = tclip.encode_image(model, torch.from_numpy(imgs)).numpy()
        txt = tclip.encode_text(model, torch.from_numpy(toks)).numpy()
    _assert_close(img, np.asarray(jclip.encode_image(params, cfg, jnp.asarray(imgs))))
    _assert_close(txt, np.asarray(jclip.encode_text(params, cfg, jnp.asarray(toks))))
    np.testing.assert_allclose(np.linalg.norm(img, axis=1), 1.0, atol=1e-5)


def test_fold_conv_bn_matches_batchnorm():
    """The folded conv equals conv → BatchNorm (eval) on the same input."""
    cfg = TINY2
    sd = full_rn_state_dict(cfg)
    folded = tloaders._fold_conv_bn(sd, "visual.layer2.0.conv2", "visual.layer2.0.bn2")
    w = sd["visual.layer2.0.conv2.weight"]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, w.shape[1], 8, 8)).astype(np.float32))
    bn = {k: sd[f"visual.layer2.0.bn2.{k}"] for k in ("weight", "bias", "running_mean", "running_var")}
    ref = torch.nn.functional.batch_norm(torch.nn.functional.conv2d(x, w, padding=1), bn["running_mean"],
                                         bn["running_var"], bn["weight"], bn["bias"], eps=1e-5)
    conv = tresnet.Conv(3, w.shape[1], w.shape[0])
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(folded["kernel"].transpose(3, 2, 0, 1).copy()))
        conv.scale.copy_(torch.from_numpy(folded["scale"]))
        conv.bias.copy_(torch.from_numpy(folded["bias"]))
        got = conv(x.permute(0, 2, 3, 1), relu=False).permute(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_init_clip_shapes_scales_and_norms():
    cfg = TEST_TINY_RN
    model = tclip.init_clip(cfg, 0, device="cpu")
    again = tclip.init_clip(cfg, 0, device="cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), name
    conv = model.visual.stages[1].head.conv2
    assert conv.kernel.shape == (16, 16, 3, 3)  # OIHW: planes = width·2
    assert abs(conv.kernel.std().item() - (9 * 16) ** -0.5) < 0.01
    assert torch.equal(conv.scale, torch.ones(16)) and torch.equal(conv.bias, torch.zeros(16))
    assert abs(model.visual.attnpool.wq.std().item() - cfg.attnpool_dim ** -0.5) < 0.01
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8))
    toks = torch.from_numpy(np.random.default_rng(1).integers(1, 500, (3, 16)).astype(np.int32))
    with torch.no_grad():
        feats, tfeat = tclip.encode_image(model, imgs), tclip.encode_text(model, toks)
    assert feats.shape == (3, 16) and tfeat.shape == (3, 16)
    np.testing.assert_allclose(feats.norm(dim=1).numpy(), 1.0, atol=1e-5)
    assert bool(torch.isfinite(feats).all())


def _jax_shapes(cfg) -> dict:
    """The JAX tree's shapes (no arrays allocated) under the port's parameter
    names: stacked blocks and tails unrolled, conv kernels HWIO → OIHW."""
    tree = jax.eval_shape(lambda: jclip.init_clip(cfg, 0))
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        shape = tuple(leaf.shape)
        if keys[-1] == "kernel":  # (..., kh, kw, I, O) → (..., O, I, kh, kw)
            shape = (*shape[:-4], shape[-1], shape[-2], shape[-4], shape[-3])
        stacked = next((i for i, k in enumerate(keys) if k in ("tail", "blocks")), None)
        if stacked is None:
            out[".".join(keys)] = shape
        else:
            for j in range(shape[0]):
                out[".".join(keys[: stacked + 1] + [str(j)] + keys[stacked + 1:])] = shape[1:]
    return out


@pytest.mark.parametrize("name", RN_CONFIGS)
def test_published_configs_build_with_the_jax_shapes(name):
    cfg = get_config(name)
    model = tclip.CLIP(cfg, torch.device("meta"))
    ours = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert all(p.is_meta for p in model.parameters())
    assert ours == _jax_shapes(cfg)
    assert model.visual.attnpool.pos_emb.shape == (cfg.grid_size ** 2 + 1, cfg.attnpool_dim)

"""Port's M-CLIP text encoder against the JAX package and HF transformers.

`encode` is held to JAX `mclip.encode` and to HF `XLMRobertaModel` with
masked mean pooling and the projection, on the tiny pair of
tests/test_models/test_mclip.py (cosine > 0.999, atol 2e-4, its bar).  A
checkpoint directory written by `save_pretrained` with a sentence-transformers
`2_Dense` projection and a `WordLevel` tokenizer.json built here loads in
both packages' `load_mclip` (the port without `transformers`) and gives the
same embeddings.  The mapper with `use_mclip` (through `inference.main`) and
a `/knn-service` query with `use_mclip: true` run on the CPU.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_retrieval_tpu.inference.mapper import ClipMapper as JaxMapper
from clip_retrieval_tpu.models import mclip as jmclip
from clip_retrieval_tpu_torch.models import mclip as tmclip

from tests.test_back.wsgi_client import request
from tests.test_inference.fixtures import make_files_corpus
from tests.test_models.test_mclip import _batch, hf_pair  # noqa: F401  (module fixture)

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

ATOL, MIN_COS = 2e-4, 0.999
D = 32  # test-tiny's embed dim, the projection's out dim below
WORDS = ["a", "photo", "of", "cat", "dog", "une", "photo_fr", "chat", "caption", "number"]


def _ref_embeddings(model, ids, mask, proj_w, proj_b):
    with torch.no_grad():
        hidden = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
    m = mask[:, :, None].astype(np.float32)
    ref = (hidden.numpy() * m).sum(1) / m.sum(1) @ proj_w + proj_b
    return ref / np.linalg.norm(ref, axis=-1, keepdims=True)


def _assert_close(ours, ref):
    cos = (ours * ref).sum(-1) / (np.linalg.norm(ours, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() > MIN_COS, cos
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def _encode(model, ids, mask=None):
    with torch.no_grad():
        return model.encode(torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask)).numpy()


def test_encode_matches_hf_and_jax(hf_pair):  # noqa: F811
    model, hf_cfg, proj_w, proj_b = hf_pair
    cfg = tmclip.config_from_hf(hf_cfg.to_dict(), out_dim=16)
    assert cfg.position_offset == 2
    assert dataclasses_equal(cfg, jmclip.config_from_hf(hf_cfg, out_dim=16))
    ours_model = tmclip.convert_hf_roberta(model.state_dict(), cfg, proj_w, proj_b, device="cpu")
    assert ours_model.type_emb is not None and ours_model.proj.b is not None
    ids, mask = _batch(hf_cfg)
    ours = _encode(ours_model, ids, mask)
    _assert_close(ours, _ref_embeddings(model, ids, mask, proj_w, proj_b))
    jparams = jmclip.convert_hf_roberta(model.state_dict(), jmclip.config_from_hf(hf_cfg, 16), proj_w, proj_b)
    ref = np.asarray(jmclip.encode(jparams, jmclip.config_from_hf(hf_cfg, 16), jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(mask, jnp.int32)))
    _assert_close(ours, ref)


def dataclasses_equal(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("bert", [False, True], ids=["roberta", "bert"])
def test_jax_params_carry_over(bert):
    """JAX `init_mclip` weights through `mclip_from_jax_params`; the BERT
    variant has plain positions (position_offset 0) and pad id 0."""
    cfg = tmclip.TEST_TINY_MCLIP
    if bert:
        cfg = dataclasses.replace(cfg, position_offset=0, pad_token_id=0)
    jcfg = jmclip.MCLIPConfig(**dataclasses.asdict(cfg))
    params = jmclip.init_mclip(jcfg, seed=3)
    model = tmclip.mclip_from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    rng = np.random.default_rng(4)
    ids = np.full((3, 9), cfg.pad_token_id, np.int64)
    for i, n in enumerate((9, 5, 2)):
        ids[i, :n] = rng.integers(3, cfg.vocab_size, n)
    ref = np.asarray(jmclip.encode(params, jcfg, jnp.asarray(ids, jnp.int32)))
    _assert_close(_encode(model, ids), ref)


def test_config_from_hf_keeps_bert_pad_id_0():
    cfg = tmclip.config_from_hf({"model_type": "bert", "vocab_size": 30, "hidden_size": 8, "num_hidden_layers": 1,
                                 "num_attention_heads": 2, "intermediate_size": 16, "max_position_embeddings": 12,
                                 "pad_token_id": 0}, out_dim=4)
    assert (cfg.pad_token_id, cfg.position_offset, cfg.layernorm_eps) == (0, 0, 1e-12)


def test_padding_leaves_the_result_unchanged():
    cfg = tmclip.TEST_TINY_MCLIP
    model = tmclip.init_mclip(cfg, seed=0, device="cpu")
    assert model.type_emb is None
    assert abs(model.word_emb.std().item() - 0.02) < 0.002
    ids = np.array([[5, 6, 7, 1, 1], [8, 9, 1, 1, 1]], np.int64)
    out = _encode(model, ids)
    assert out.shape == (2, cfg.out_dim)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    ids2 = np.array([[5, 6, 7, 1, 1, 1, 1], [8, 9, 1, 1, 1, 1, 1]], np.int64)
    np.testing.assert_allclose(out, _encode(model, ids2), atol=1e-5)
    again = tmclip.init_mclip(cfg, seed=0, device="cpu")
    assert torch.equal(again.blocks[1].mlp.w_out, model.blocks[1].mlp.w_out)


# -- projections --------------------------------------------------------------


def _write_projection(folder, layout, w, b):
    """w: (out, in) as torch stores a Linear."""
    if layout == "npz":
        np.savez(folder / "projection.npz", w=w.T, **({} if b is None else {"b": b}))
        return
    dense = folder / "2_Dense"
    dense.mkdir()
    sd = {"linear.weight": torch.from_numpy(w), **({} if b is None else {"linear.bias": torch.from_numpy(b)})}
    if layout == "bin":
        torch.save(sd, dense / "pytorch_model.bin")
    else:
        import safetensors.torch

        safetensors.torch.save_file(sd, str(dense / "model.safetensors"))


@pytest.mark.parametrize("layout,bias", [("npz", True), ("npz", False), ("bin", True), ("safetensors", False)])
def test_load_projection_layouts_match_jax(tmp_path, layout, bias):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 48)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32) if bias else None
    _write_projection(tmp_path, layout, w, b)
    pw, pb = tmclip._load_projection(str(tmp_path))
    jw, jb = jmclip._load_projection(str(tmp_path))
    np.testing.assert_array_equal(pw, w.T)
    np.testing.assert_array_equal(pw, jw)
    assert (pb is None) == (jb is None) == (not bias)
    if bias:
        np.testing.assert_array_equal(pb, b)


def test_load_projection_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="2_Dense"):
        tmclip._load_projection(str(tmp_path))


# -- a checkpoint directory in both packages -----------------------------------


def _tokenizer_json(path):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 3, **{w: 4 + i for i, w in enumerate(WORDS)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path))


@pytest.fixture(scope="module")
def mclip_dir(tmp_path_factory):
    """save_pretrained (model.safetensors) + 2_Dense (pytorch_model.bin,
    hidden 32 → D) + a WordLevel tokenizer.json."""
    d = tmp_path_factory.mktemp("mclip_ckpt")
    cfg = transformers.XLMRobertaConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                                        intermediate_size=64, max_position_embeddings=40, pad_token_id=1,
                                        layer_norm_eps=1e-5)
    torch.manual_seed(0)
    model = transformers.XLMRobertaModel(cfg, add_pooling_layer=False).eval()
    model.save_pretrained(str(d))
    rng = np.random.default_rng(1)
    _write_projection(d, "bin", (rng.normal(size=(D, 32)) * 0.2).astype(np.float32),
                      (rng.normal(size=(D,)) * 0.01).astype(np.float32))
    _tokenizer_json(d / "tokenizer.json")
    return d


TEXTS = ["a photo of cat", "a photo of dog", "une photo_fr chat", "caption number", "a"]


def test_load_mclip_matches_jax(mclip_dir):
    ours = tmclip.load_mclip(str(mclip_dir), device="cpu")
    jax_bundle = jmclip.load_mclip(str(mclip_dir))
    assert dataclasses_equal(ours.cfg, jax_bundle.cfg) and ours.cfg.out_dim == D
    got, want = ours(TEXTS), jax_bundle(TEXTS)
    assert got.dtype == want.dtype == np.float16 and got.shape == (len(TEXTS), D)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=1e-3)
    # the f32 encodings, before the fp16 cast, at the tower bar
    ids = [e.ids for e in ours.tokenizer.encode_batch(TEXTS)]
    width = max(map(len, ids))
    arr = np.full((len(ids), width), 1, np.int64)
    mask = np.zeros_like(arr)
    for i, e in enumerate(ids):
        arr[i, : len(e)], mask[i, : len(e)] = e, 1
    ref = np.asarray(jmclip.encode(jax_bundle.params, jax_bundle.cfg, jnp.asarray(arr, jnp.int32),
                                   jnp.asarray(mask, jnp.int32)))
    _assert_close(_encode(ours.model, arr, mask), ref)
    np.testing.assert_array_equal(ours("a photo of cat"), got[:1])


@pytest.mark.parametrize("prefix", ["", "roberta.", "transformer."])
def test_load_mclip_reads_pytorch_model_bin_with_prefixes(mclip_dir, tmp_path, prefix):
    """`pytorch_model.bin` (the card's machine has no safetensors package)
    with the key prefixes the JAX loader strips: the same embeddings."""
    import safetensors.torch

    for name in ("config.json", "tokenizer.json"):
        (tmp_path / name).write_bytes((mclip_dir / name).read_bytes())
    os.makedirs(tmp_path / "2_Dense")
    (tmp_path / "2_Dense" / "pytorch_model.bin").write_bytes((mclip_dir / "2_Dense" / "pytorch_model.bin").read_bytes())
    sd = safetensors.torch.load_file(str(mclip_dir / "model.safetensors"))
    torch.save({prefix + k: v for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    want = tmclip.load_mclip(str(mclip_dir), device="cpu")(TEXTS)
    np.testing.assert_array_equal(tmclip.load_mclip(str(tmp_path), device="cpu")(TEXTS), want)


def test_load_mclip_without_safetensors_says_why(mclip_dir, tmp_path, monkeypatch):
    for name in ("config.json", "model.safetensors"):
        (tmp_path / name).write_bytes((mclip_dir / name).read_bytes())
    np.savez(tmp_path / "projection.npz", w=np.zeros((32, D), np.float32))
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors"):
        tmclip.load_mclip(str(tmp_path), device="cpu")
    os.remove(tmp_path / "model.safetensors")
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        tmclip.load_mclip(str(tmp_path), device="cpu")


def test_bundle_without_tokenizer_raises(mclip_dir, tmp_path):
    for name in ("config.json", "model.safetensors"):
        (tmp_path / name).write_bytes((mclip_dir / name).read_bytes())
    np.savez(tmp_path / "projection.npz", w=np.ones((32, D), np.float32))
    bundle = tmclip.load_mclip(str(tmp_path), device="cpu")
    assert bundle.tokenizer is None and bundle.cfg.out_dim == D
    with pytest.raises(RuntimeError, match="tokenizer"):
        bundle(["a photo"])


# -- the mapper and /knn-service with use_mclip ---------------------------------


def test_inference_main_with_mclip_matches_the_jax_mapper(mclip_dir, tmp_path):
    from clip_retrieval_tpu_torch.inference.main import main as torch_inference

    dataset = make_files_corpus(str(tmp_path / "c"), n=6)
    out = tmp_path / "out"
    torch_inference(input_dataset=dataset, output_folder=str(out), clip_model="test-tiny", batch_size=4,
                    num_prepro_workers=1, use_mclip=True, mclip_model=str(mclip_dir), device="cpu")
    got = np.load(out / "text_emb" / "text_emb_0.npy")
    captions = pd.read_parquet(out / "metadata" / "metadata_0.parquet")["caption"].tolist()
    assert got.shape == (6, D) and got.dtype == np.float16
    jax_mapper = JaxMapper(enable_image=False, enable_text=True, clip_model="test-tiny", use_mclip=True,
                           mclip_model=str(mclip_dir), batch_size=4)
    want = jax_mapper({"text": captions, "text_tokens": np.zeros((len(captions), 16), np.int32)})["text_embs"]
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=1e-3)
    assert np.load(out / "img_emb" / "img_emb_0.npy").shape == (6, D)


@pytest.fixture(scope="module")
def mclip_served(mclip_dir, tmp_path_factory):
    """A Flat index of 200 seeded unit rows built by the port's `clip_index`,
    served with `enable_mclip_option` by the port's app."""
    from clip_retrieval_tpu_torch.back.app import make_app
    from clip_retrieval_tpu_torch.back.options import ClipOptions
    from clip_retrieval_tpu_torch.back.resources import load_clip_indices
    from clip_retrieval_tpu_torch.index.build import clip_index

    root = tmp_path_factory.mktemp("mclip_serving")
    emb = root / "emb"
    (emb / "img_emb").mkdir(parents=True)
    (emb / "metadata").mkdir()
    x = np.random.default_rng(0).normal(size=(200, D))
    np.save(emb / "img_emb" / "img_emb_0.npy", (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float16))
    pd.DataFrame({"caption": [f"row {i}" for i in range(200)]}).to_parquet(emb / "metadata" / "metadata_0.parquet")
    clip_index(str(emb), str(root / "index"), index_key="Flat", device="cpu")
    paths = root / "paths.json"
    paths.write_text(json.dumps({"m": str(root / "index")}))

    def load(mclip_model):
        return load_clip_indices(str(paths), ClipOptions(
            indice_folder="", clip_model="test-tiny", enable_mclip_option=True, mclip_model=mclip_model,
            columns_to_return=["caption"], provide_aesthetic_embeddings=False, device="cpu"))

    resources = load(str(mclip_dir))
    return resources, make_app(resources, device="cpu"), load


def test_knn_service_use_mclip_answers_the_bundles_search(mclip_served):
    resources, app, _ = mclip_served
    bundle = resources["m"].model_txt_mclip
    assert isinstance(bundle, tmclip.MCLIPBundle)
    for text in ("a photo of cat", "une photo_fr chat"):
        body = {"text": text, "use_mclip": True, "num_images": 7, "indice_name": "m", "deduplicate": False,
                "use_safety_model": False, "use_violence_detector": False}
        r = request(app, "POST", "/knn-service", body)
        assert r["status"].startswith("200"), r["body"]
        q = bundle(text).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        _, ids = resources["m"].image_index.search(q, 7)
        assert [item["id"] for item in r["json"]] == ids[0].tolist()
        assert all(item["caption"] == f"row {item['id']}" for item in r["json"])


def test_unloadable_mclip_is_switched_off_with_a_warning(mclip_served, tmp_path, caplog):
    _, _, load = mclip_served
    with caplog.at_level("WARNING", logger="clip_back"):
        resources = load(str(tmp_path / "missing"))
    assert resources["m"].model_txt_mclip is None
    assert "use_mclip disabled" in caplog.text


def test_mclip_loaders_default_to_cuda(monkeypatch, mclip_dir):
    from clip_retrieval_tpu_torch.inference.mapper import ClipMapper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmclip.load_mclip(str(mclip_dir)), lambda: tmclip.init_mclip(tmclip.TEST_TINY_MCLIP),
                 lambda: ClipMapper(enable_image=False, enable_text=True, clip_model="test-tiny", use_mclip=True,
                                    mclip_model=str(mclip_dir))):
        with pytest.raises(RuntimeError, match="is_available"):
            call()

"""EVA02-CLIP-L/14's equations in the port (`test-tiny-eva`, seeded random
weights in open_clip's layout, float32 on the CPU), held to the plain
reference `tests/plain_ref/eva_ref.py`.

The reference writes the rotation as EVA-CLIP does (an outer product of
positions and frequencies, repeated in pairs, the row and column tables
concatenated, then x·cos + rotate_half(x)·sin); the port writes it from the
closed form (`models/clip.py::rope_table`, pairs turned in
`ops/block_fused.py`).  So the two formulations check each other.  Besides:
the rotation at the grid's corners, the class row left unturned, the
hidden's zero padding, the loader's keys, the registered widths, and the
embedding job's rows.  The `cuda`-marked tests hold the two new kernels to
their plain versions at the cell's shapes (2730 wide, 577 rows an image) on
the card: `python -m pytest tests/test_torch_eva.py -m cuda`.
"""

from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

from clip_retrieval_tpu_torch.inference.worker import worker
from clip_retrieval_tpu_torch.models import clip as tclip
from clip_retrieval_tpu_torch.models import configs, loaders, zoo
from clip_retrieval_tpu_torch.ops import block_fused

from tests.plain_ref import eva_ref
from tests.test_inference.fixtures import make_files_corpus

CFG = configs.get_config("test-tiny-eva")
REF_CFG = dataclasses.asdict(CFG)
ROOT = Path(__file__).resolve().parents[1]
EVA_FIELDS = ("text_layernorm_eps", "rope", "rope_grid", "vision_mlp", "attn_ln", "vision_proj_bias")


def open_clip_eva_state_dict(cfg, seed: int = 17) -> dict:
    """Every tensor of an open_clip EVA02 model's state dict at `cfg`'s widths
    (timm's `Eva` trunk under `visual.trunk.`, open_clip's text tower),
    seeded: weights N(0, 0.3²), biases N(0, 0.1²), LayerNorm weights 1 +
    N(0, 0.1²), so that a dropped bias, affine or norm shows."""
    w, tw, p, e = cfg.vision_width, cfg.text_width, cfg.patch_size, cfg.embed_dim
    h = int(round(w * cfg.vision_mlp_ratio))
    tm = int(round(tw * cfg.text_mlp_ratio))
    lin = lambda k, o, i, bias=True: [(k + ".weight", (o, i))] + ([(k + ".bias", (o,))] if bias else [])  # noqa: E731
    ln = lambda k, n: [(k + ".weight", (n,)), (k + ".bias", (n,))]  # noqa: E731
    t = "visual.trunk."
    shapes = [(t + "cls_token", (1, 1, w)), (t + "pos_embed", (1, cfg.vision_seq_len, w)),
              (t + "patch_embed.proj.weight", (w, 3, p, p)), (t + "patch_embed.proj.bias", (w,))]
    for i in range(cfg.vision_layers):
        b = f"{t}blocks.{i}."
        shapes += ln(b + "norm1", w) + lin(b + "attn.q_proj", w, w) + lin(b + "attn.k_proj", w, w, bias=False)
        shapes += lin(b + "attn.v_proj", w, w) + ln(b + "attn.norm", w) + lin(b + "attn.proj", w, w)
        shapes += ln(b + "norm2", w) + lin(b + "mlp.fc1_g", h, w) + lin(b + "mlp.fc1_x", h, w)
        shapes += ln(b + "mlp.norm", h) + lin(b + "mlp.fc2", w, h)
    shapes += ln(t + "norm", w) + lin(t + "head", e, w)
    shapes += [("positional_embedding", (cfg.context_length, tw)), ("text_projection", (tw, e)),
               ("logit_scale", ()), ("token_embedding.weight", (cfg.vocab_size, tw))]
    for i in range(cfg.text_layers):
        b = f"transformer.resblocks.{i}."
        shapes += ln(b + "ln_1", tw) + [(b + "attn.in_proj_weight", (3 * tw, tw)), (b + "attn.in_proj_bias", (3 * tw,))]
        shapes += lin(b + "attn.out_proj", tw, tw) + ln(b + "ln_2", tw)
        shapes += lin(b + "mlp.c_fc", tm, tw) + lin(b + "mlp.c_proj", tw, tm)
    shapes += ln("ln_final", tw)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in shapes:
        x = torch.randn(shape, generator=gen)
        if key.endswith(".weight") and ("norm" in key or "ln_" in key):
            x = 1 + 0.1 * x
        elif len(shape) <= 1:
            x = 0.1 * x
        else:
            x = 0.3 * x
        sd[key] = x
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return sd


@pytest.fixture(scope="module")
def sd():
    return open_clip_eva_state_dict(CFG)


@pytest.fixture(scope="module")
def port(sd):
    return loaders.convert_eva_state_dict(sd, CFG, "cpu").eval()


def _images(n=3, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, 40, 40, 3), dtype=np.uint8))


CAPTIONS = ["a cat", "caption number 7", "", "x" * 40]


def _tokens():
    return torch.from_numpy(np.stack([eva_ref.tokenize(c, CFG.context_length) for c in CAPTIONS]))


@pytest.mark.parametrize("tower", ["image", "text"])
def test_port_matches_the_reference(port, sd, tower):
    """Both in float32 from the same state dict: the port's features within
    atol 2e-5 and cosine ≥ 0.99999 of the reference's (float32 sums in
    another order through two layers, and the port's rotary table rounded
    once from float64, each ~1e-6; a dropped bias, norm or turn moves them by
    ≥ 1e-2)."""
    with torch.no_grad():
        if tower == "image":
            got = tclip.encode_image(port, _images())
            ref = eva_ref.encode_image(sd, REF_CFG, _images())
        else:
            got = tclip.encode_text(port, _tokens())
            ref = eva_ref.encode_text(sd, REF_CFG, _tokens())
    assert F.cosine_similarity(got.double(), ref.double(), dim=-1).min().item() >= 0.99999
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


def _closed_form(r: int, c: int, grid: int, ref_grid: int, dh: int) -> np.ndarray:
    """The angles of the patch at row r, column c, from the equations: f_j =
    10000^(−j/(dh/4)); pair i < dh/4 turns by (r·ref/grid)·f_i, the others by
    (c·ref/grid)·f_{i − dh/4}."""
    n = dh // 4
    f = [10000.0 ** (-j / n) for j in range(n)]
    return np.array([r * ref_grid / grid * f[i] for i in range(n)] + [c * ref_grid / grid * f[i] for i in range(n)])


@pytest.mark.parametrize("cfg_name", ["test-tiny-eva", "EVA02-L-14-336"])
def test_rotation_table_at_the_corners(cfg_name):
    """The port's table and the reference's EVA-CLIP form against the closed
    form at the four corner patches (at EVA02-L: rows 0 and 23 of 24, placed
    at 0 and 23·16/24 on the 16 × 16 reference grid)."""
    cfg = configs.get_config(cfg_name)
    g, dh = cfg.grid_size, cfg.vision_head_dim
    table = tclip.rope_table(g, cfg.rope_grid, dh).double()
    assert table.shape == (2, g * g, dh // 2)
    cos, sin = eva_ref.rope_cos_sin(g, cfg.rope_grid, dh)
    for r, c in ((0, 0), (0, g - 1), (g - 1, 0), (g - 1, g - 1)):
        want = _closed_form(r, c, g, cfg.rope_grid, dh)
        p = r * g + c
        np.testing.assert_allclose(table[0, p].numpy(), np.cos(want), atol=1e-7)
        np.testing.assert_allclose(table[1, p].numpy(), np.sin(want), atol=1e-7)
        # the reference repeats each pair's angle (float32 angles up to 15.4 rad: ~1e-6)
        np.testing.assert_allclose(cos[p].numpy(), np.repeat(np.cos(want), 2), atol=2e-6)
        np.testing.assert_allclose(sin[p].numpy(), np.repeat(np.sin(want), 2), atol=2e-6)


def test_only_patch_rows_turn():
    """The rotary epilogue leaves the class row as acc + bias, turns every
    pair of the patch rows by its angle (each pair's length kept), and equals
    the reference's x·cos + rotate_half(x)·sin there."""
    g, dh, heads = 3, 12, 2
    gen = torch.Generator().manual_seed(5)
    acc = torch.randn(2, 1 + g * g, heads * dh, generator=gen)
    bias = torch.randn(heads * dh, generator=gen)
    table = tclip.rope_table(g, 2, dh)
    out = block_fused.rope_epilogue(acc, bias, table, prefix=1, dtype=torch.float32)
    y = acc + bias
    assert torch.equal(out[:, 0], y[:, 0])
    pairs = lambda t: t[:, 1:].reshape(2, g * g, heads, dh // 2, 2)  # noqa: E731
    torch.testing.assert_close(pairs(out).norm(dim=-1), pairs(y).norm(dim=-1))
    cos, sin = eva_ref.rope_cos_sin(g, 2, dh)
    heads_of = lambda t: t.reshape(2, -1, heads, dh).transpose(1, 2)  # noqa: E731
    want = eva_ref.rotate(heads_of(y[:, 1:]), cos, sin)
    torch.testing.assert_close(heads_of(out[:, 1:]), want, atol=1e-6, rtol=1e-6)
    assert not torch.allclose(out[:, 1:], y[:, 1:])


def test_zero_padding_gives_the_unpadded_result(port, monkeypatch):
    """At `GLU_ALIGN` 8 the hidden of 42 runs as 48 columns, the last 6 zero;
    the block's output is the unpadded one (GLU_ALIGN 1) up to the order of
    float32 sums (the zero terms add nothing)."""
    assert CFG.vision_mlp_ratio * CFG.vision_width % 8 != 0
    blk = port.visual.blocks[0]
    x = torch.randn(2, CFG.vision_seq_len, CFG.vision_width, generator=torch.Generator().manual_seed(2))
    rope = (port.visual.rope, 1)
    with torch.no_grad():
        hidden, w_out = blk.mlp.hidden(x, blk.eps)
        assert hidden.shape[-1] == 48 and w_out.shape[0] == 48
        assert not hidden[..., 42:].any() and not w_out[42:].any()
        padded = blk(x, "auto", rope)
        monkeypatch.setattr(tclip, "GLU_ALIGN", 1)
        assert blk.mlp.hidden(x, blk.eps)[0].shape[-1] == 42
        unpadded = blk(x, "auto", rope)
    torch.testing.assert_close(padded, unpadded, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(hidden[..., :42], blk.mlp.hidden(x, blk.eps)[0])


class _Reads(dict):
    """A state dict that notes the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_convert_reads_every_key(sd):
    """Every key of the open_clip layout lands in the port's module and each
    element is held once: the port's parameters are the state dict's plus
    k's bias, zeros."""
    tracked = _Reads(sd)
    model = loaders.convert_eva_state_dict(tracked, CFG, "cpu")
    assert tracked.read == set(sd)
    zeros = CFG.vision_layers * CFG.vision_width
    assert tclip.count_params(model) == sum(v.numel() for v in sd.values()) + zeros
    v = model.visual
    assert v.ln_pre is None and all(not blk.attn.bk.any() for blk in v.blocks)
    np.testing.assert_array_equal(v.blocks[1].mlp.w_gate.numpy(),
                                  sd["visual.trunk.blocks.1.mlp.fc1_g.weight"].T.numpy())
    np.testing.assert_array_equal(v.blocks[0].attn.ln.scale.numpy(), sd["visual.trunk.blocks.0.attn.norm.weight"])
    np.testing.assert_array_equal(v.proj_bias.numpy(), sd["visual.trunk.head.bias"].numpy())
    assert "rope" not in model.state_dict()  # the table is made at construction, not loaded
    with pytest.raises(ValueError, match="not an EVA02 config"):
        loaders.convert_eva_state_dict(sd, configs.get_config("test-tiny"), "cpu")


def _bpe(tmp_path):
    """A merges file without merges: a checkpoint refuses the byte fallback,
    and an empty merge list gives the byte-level vocabulary through the BPE
    path."""
    path = tmp_path / "merges.txt"
    path.write_text("#version: 0.2\n")
    return str(path)


def test_the_format_is_detected_and_loads_from_a_checkpoint(sd, tmp_path, monkeypatch):
    assert loaders.detect_format(sd) == "open_clip_eva"
    path = str(tmp_path / "eva.pt")
    torch.save(sd, path)
    monkeypatch.setenv("CRT_BPE_PATH", _bpe(tmp_path))
    for name in ("test-tiny-eva", "open_clip:test-tiny-eva/merged2b_s6b_b61k"):
        bundle = zoo.load_model(name, checkpoint=path, device="cpu")
        assert bundle.cfg is CFG
        with torch.no_grad():
            got = tclip.encode_image(bundle.model, _images())
        np.testing.assert_allclose(got.numpy(), eva_ref.encode_image(sd, REF_CFG, _images()).numpy(), atol=2e-5)
        np.testing.assert_array_equal(bundle.tokenize(CAPTIONS), _tokens().numpy())


def test_embedding_job_writes_the_references_rows(sd, tmp_path, monkeypatch):
    """`inference.worker` with `clip_model="open_clip:test-tiny-eva/..."` and a
    checkpoint: FilesReader (forked decode pool) → DeviceStagingReader →
    ClipMapper → NumpyWriter over JPEGs resized and centre-cropped.  The fp16
    rows equal the reference's float32 rows to fp16 rounding (atol 1e-3: an
    fp16 value near 0.5 is held to 2.4e-4)."""
    monkeypatch.setenv("CRT_BPE_PATH", _bpe(tmp_path))
    corpus = make_files_corpus(str(tmp_path / "corpus"), n=7)
    ckpt = str(tmp_path / "eva.pt")
    torch.save(sd, ckpt)
    out = str(tmp_path / "out")
    worker([0], corpus, out, 1, clip_model="open_clip:test-tiny-eva/merged2b_s6b_b61k", checkpoint=ckpt,
           batch_size=4, num_prepro_workers=2, device="cpu")
    meta = pd.read_parquet(os.path.join(out, "metadata", "metadata_0.parquet"))
    img = np.load(os.path.join(out, "img_emb", "img_emb_0.npy"))
    txt = np.load(os.path.join(out, "text_emb", "text_emb_0.npy"))
    assert img.dtype == np.float16 and img.shape == (7, CFG.embed_dim) == txt.shape
    images = np.stack([eva_ref.preprocess(Path(p).read_bytes(), CFG.image_size) for p in meta["image_path"]])
    tokens = np.stack([eva_ref.tokenize(c, CFG.context_length) for c in meta["caption"]])
    with torch.no_grad():
        ref_img = eva_ref.encode_image(sd, REF_CFG, torch.from_numpy(images))
        ref_txt = eva_ref.encode_text(sd, REF_CFG, torch.from_numpy(tokens))
    for got, ref in ((img, ref_img), (txt, ref_txt)):
        got = torch.from_numpy(got.astype(np.float32))
        assert F.cosine_similarity(got.double(), ref.double(), dim=-1).min().item() >= 0.9999
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-3)


def test_benchmark_copy_of_the_reference_is_byte_identical():
    assert (ROOT / "portbench" / "reference" / "eva_ref.py").read_bytes() == \
        (ROOT / "tests" / "plain_ref" / "eva_ref.py").read_bytes()


def test_registered_widths_and_other_configs_unchanged():
    """EVA02-L/14-336 at its published widths (428 M parameters counted on
    the meta device); every other registered configuration keeps the EVA02
    fields at their defaults."""
    eva = configs.get_config("EVA02-L-14-336")
    mlp = int(round(eva.vision_width * eva.vision_mlp_ratio))
    assert (eva.grid_size, eva.vision_seq_len, eva.vision_head_dim, eva.text_head_dim, mlp) == (24, 577, 64, 64, 2730)
    assert mlp == int(1024 * 8 / 3)
    assert (eva.embed_dim, eva.layernorm_eps, eva.text_eps, eva.act, eva.rope, eva.rope_grid) == (
        768, 1e-6, 1e-5, "gelu", "2d", 16)
    assert (eva.class_token, eva.ln_pre, eva.patch_bias, eva.vision_mlp, eva.attn_ln, eva.vision_proj_bias,
            eva.resize, eva.tokenizer) == (True, False, True, "swiglu", True, True, "crop", "clip")
    assert eva.image_mean == configs.CLIPConfig().image_mean
    assert 428.0e6 < tclip.count_params(tclip.CLIP(eva, device="meta")) < 428.2e6
    defaults = configs.CLIPConfig()
    for name in configs.list_configs():
        cfg = configs.get_config(name)
        if "eva" not in name.lower():
            assert all(getattr(cfg, f) == getattr(defaults, f) for f in EVA_FIELDS), name
            assert cfg.text_eps == cfg.layernorm_eps


# -- the kernels on the card ---------------------------------------------------

# EVA02-L/14-336 at batch 256: 256 × 577 rows, width 1024 in 16 heads of 64; the
# SwiGLU hidden 2730, padded to 2736
ROWS, SEQ, WIDTH, HEAD_DIM, HIDDEN, PADDED = 256 * 577, 577, 1024, 64, 2730, 2736


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), in f32."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_rope_matches_its_plain_version(dtype):
    """At the cell's q/k shape: f32 within 1e-5 of the plain version (the
    products may fuse into FMAs), bf16 within one bf16 ulp of it or 1e-6.
    Also the scalar route: no bias, a head dim of 12 (pairs across 8-wide
    chunks) and an unaligned accumulator."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    acc = torch.randn(256, SEQ, WIDTH, generator=gen, device=dev) * 2
    bias = torch.randn(WIDTH, generator=gen, device=dev) * 0.5
    table = tclip.rope_table(24, 16, HEAD_DIM).to(dev)
    launches = block_fused.rope_epilogue.launches
    got = block_fused.rope_epilogue(acc, bias, table, prefix=1, dtype=dtype)
    torch.cuda.synchronize()
    assert block_fused.rope_epilogue.launches == launches + 1
    want = block_fused.rope_reference(acc, bias, table, 1, dtype)
    _close(got, want, dtype)
    del got, want
    small = tclip.rope_table(5, 3, 12).to(dev)
    unaligned = torch.randn(2 * 26 * 48 + 1, generator=gen, device=dev)[1:].reshape(2, 26, 48)
    for b in (None, torch.randn(48, generator=gen, device=dev)):
        for a in (unaligned, unaligned.clone()):
            got = block_fused.rope_epilogue(a, b, small, prefix=1, dtype=dtype)
            torch.cuda.synchronize()
            _close(got, block_fused.rope_reference(a, b, small, 1, dtype), dtype)


def _close(got, want, dtype):
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        assert bool(((diff <= _bf16_ulp(want)) | (diff <= 1e-6)).all()), diff.max().item()
    else:
        assert diff.max().item() <= 1e-5, diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [PADDED, HIDDEN], ids=["padded", "unpadded"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_glu_layernorm_matches_its_plain_version(dtype, padded):
    """At the cell's gate shape (256 × 577 rows, 2730 of 2736 columns, or the
    unpadded 2730 on the scalar route): within one bf16 ulp of the plain
    version or 1e-5 (statistics summed in another order, ~1e-6 of the row's
    scale); f32 within 2e-5; the pad columns exact zeros."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = ROWS if dtype == torch.bfloat16 else ROWS // 4
    acc = torch.randn(rows, 2 * padded, generator=gen, device=dev) * 1.5
    bias = torch.randn(2 * padded, generator=gen, device=dev) * 0.3
    scale = torch.randn(HIDDEN, generator=gen, device=dev) * 0.2 + 1
    ln_bias = torch.randn(HIDDEN, generator=gen, device=dev) * 0.1
    launches = block_fused.glu_layernorm.launches
    got = block_fused.glu_layernorm(acc, bias, scale, ln_bias, 1e-6, dtype=dtype)
    torch.cuda.synchronize()
    assert block_fused.glu_layernorm.launches == launches + 1
    want = block_fused.glu_layernorm_reference(acc, bias, scale, ln_bias, 1e-6, dtype)
    assert got.shape == (rows, padded) and got.dtype == dtype
    assert not got[:, HIDDEN:].any()
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        assert bool(((diff <= _bf16_ulp(want)) | (diff <= 1e-5)).all()), diff.max().item()
    else:
        assert diff.max().item() <= 2e-5, diff.max().item()


@pytest.mark.cuda
def test_cuda_eva_towers_take_the_kernels(sd):
    """Under inference mode every dense, LayerNorm, rotary and gate pass of
    both tiny EVA02 towers launches a kernel (2 rotary launches and 1 gate
    launch an image layer, no eager call), and the bf16 features stay within
    the repo's tower bar (cosine ≥ 0.999) of the float32 reference."""
    dev = _cuda()
    model = loaders.convert_eva_state_dict(sd, CFG, dev).eval()
    with torch.inference_mode():
        before = (*block_fused.counts(), block_fused.rope_epilogue.launches, block_fused.glu_layernorm.launches)
        got = (tclip.encode_image(model, _images().to(dev), compute_dtype=torch.bfloat16),
               tclip.encode_text(model, _tokens().to(dev), compute_dtype=torch.bfloat16))
        torch.cuda.synchronize()
        now = (*block_fused.counts(), block_fused.rope_epilogue.launches, block_fused.glu_layernorm.launches)
        ref = (eva_ref.encode_image(sd, REF_CFG, _images()), eva_ref.encode_text(sd, REF_CFG, _tokens()))
    assert now[1] == before[1] and now[0] > before[0]
    assert (now[2] - before[2], now[3] - before[3]) == (2 * CFG.vision_layers, CFG.vision_layers)
    for g, r in zip(got, ref):
        assert F.cosine_similarity(g.cpu(), r, dim=-1).min().item() >= 0.999

"""The block's fused elementwise passes (`ops/block_fused.py`, kernels in
`csrc/block_fused.cu`): the epilogue after each dense and the one-pass
LayerNorm.

On the CPU: the plain versions are the eager chain the towers ran before the
fusion, bit for bit; the route follows the device and autograd; the towers
(`test-tiny`, `test-tiny-siglip`) return exactly what the eager chain
returns, in f32 and bf16; a differentiable forward keeps its gradients.  The
`cuda`-marked tests hold the kernels to the eager chain on the card at the
benchmark cells' shapes (`python -m pytest tests/test_torch_block_fused.py
-m cuda` on a machine with an NVIDIA GPU and nvcc).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clip_retrieval_tpu_torch.models import clip as tclip
from clip_retrieval_tpu_torch.models import configs
from clip_retrieval_tpu_torch.ops import block_fused

ACTS = [None, "quick_gelu", "gelu", "gelu_tanh"]
DTYPES = [torch.bfloat16, torch.float32]


# -- the eager chain as `models/clip.py` ran it before the fusion -------------


def _eager_act(x, kind):
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "gelu":
        return F.gelu(x, approximate="none")
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _eager_dense(x, w, b=None):
    y = tclip.matmul_f32(x, w)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _eager_ln_forward(self, x, eps):
    y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(), self.bias.float(), eps)
    return y.to(x.dtype)


def _eager_block_forward(self, x, attn_impl="auto", rope=None):
    assert rope is None and self.attn.ln is None, "the eager chain before the fusion had no EVA02 block"
    y = self.ln_1(x, self.eps)
    a = self.attn
    q = _eager_dense(y, a.wq, a.bq)
    k = _eager_dense(y, a.wk, a.bk)
    v = _eager_dense(y, a.wv, a.bv)
    o = tclip.attn_ops.sdpa_packed(q, k, v, self.heads, causal=self.causal, impl=attn_impl)
    x = x + _eager_dense(o, a.wo, a.bo)
    y = self.ln_2(x, self.eps)
    m = self.mlp
    y = _eager_act(_eager_dense(y, m.w_in, m.b_in), self.act)
    return x + _eager_dense(y, m.w_out, m.b_out)


def _eager_map_head_forward(self, x):
    b, s, w = x.shape
    a, dh = self.attn, w // self.heads
    q = _eager_dense(self.probe.to(x.dtype).reshape(1, w), a.wq, a.bq)
    k = _eager_dense(x, a.wk, a.bk)
    v = _eager_dense(x, a.wv, a.bv)
    split = lambda t: t.reshape(t.shape[0], -1, self.heads, dh).transpose(1, 2)  # noqa: E731
    o = tclip.attn_ops.sdpa(split(q).expand(b, -1, -1, -1), split(k), split(v), impl="xla")
    h = _eager_dense(o.reshape(b, w), a.wo, a.bo)
    m = self.mlp
    y = _eager_act(_eager_dense(self.ln(h, self.eps), m.w_in, m.b_in), self.act)
    return h.float() + tclip.matmul_f32(y, m.w_out) + m.b_out.float()


@pytest.fixture
def eager(monkeypatch):
    """A context that runs the towers on the eager chain."""

    class Eager:
        def __enter__(self):
            monkeypatch.setattr(tclip, "_dense", _eager_dense)
            monkeypatch.setattr(tclip.LayerNorm, "forward", _eager_ln_forward)
            monkeypatch.setattr(tclip.Block, "forward", _eager_block_forward)
            monkeypatch.setattr(tclip.MapHead, "forward", _eager_map_head_forward)

        def __exit__(self, *exc):
            monkeypatch.undo()

    return Eager()


def _rng_tensor(rng, shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


# -- plain versions and routes (CPU) ------------------------------------------


@pytest.mark.parametrize("n", [1152, 4304])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("with_residual", [False, True], ids=["no_residual", "residual"])
@pytest.mark.parametrize("act", ACTS, ids=["none", "quick_gelu", "gelu", "gelu_tanh"])
def test_plain_epilogue_is_the_eager_chain(act, with_residual, dtype, n):
    rng = np.random.default_rng(n + 7 * ACTS.index(act))
    acc = _rng_tensor(rng, (37, n), scale=3.0)
    bias = _rng_tensor(rng, (n,), scale=0.5)
    res = _rng_tensor(rng, (37, n), dtype) if with_residual else None
    want = (acc + bias.float()).to(dtype)
    if act is not None:
        want = _eager_act(want, act)
    if res is not None:
        want = res + want
    got = block_fused.dense_epilogue(acc, bias, act=act, residual=res, dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(block_fused.dense_epilogue_reference(acc, bias, act, res, dtype), want)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("w", [768, 1152])
def test_plain_layernorm_is_the_eager_chain(w, dtype, eps):
    rng = np.random.default_rng(w)
    x = _rng_tensor(rng, (2, 19, w), dtype, scale=2.0) + 0.3
    ln = tclip.LayerNorm(w)
    ln.scale.data = _rng_tensor(rng, (w,), scale=0.2) + 1
    ln.bias.data = _rng_tensor(rng, (w,), scale=0.1)
    want = _eager_ln_forward(ln, x, eps)
    assert torch.equal(block_fused.layernorm(x, ln.scale, ln.bias, eps), want)
    assert torch.equal(ln(x, eps), want)


def test_cpu_tensors_take_the_plain_version_and_grad_the_eager_chain():
    """No grad on the CPU: the wrappers' plain versions, counted neither as a
    launch nor as an eager call.  An input requiring grad: the eager chain,
    differentiable, counted by `record_eager`; the wrappers refuse it."""
    rng = np.random.default_rng(0)
    x, w, b = _rng_tensor(rng, (5, 16)), _rng_tensor(rng, (16, 24)), _rng_tensor(rng, (24,))
    res = _rng_tensor(rng, (5, 24))
    ln = tclip.LayerNorm(16)
    before = block_fused.counts()
    y = tclip._dense(x, w, b, act="quick_gelu", residual=res)
    z = ln(x, 1e-5)
    assert block_fused.counts() == before
    assert torch.equal(y, res + _eager_act(_eager_dense(x, w, b), "quick_gelu"))
    assert torch.equal(z, _eager_ln_forward(ln, x, 1e-5))

    xg = x.clone().requires_grad_(True)
    yg = tclip._dense(xg, w, b, act="gelu", residual=res)
    zg = ln(xg, 1e-5)
    assert block_fused.counts() == (before[0], before[1] + 2)
    assert yg.grad_fn is not None and zg.grad_fn is not None
    assert torch.equal(yg, res + _eager_act(_eager_dense(x, w, b), "gelu"))
    (yg.sum() + zg.sum()).backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    with torch.no_grad():  # autograd records nothing: the wrappers again
        tclip._dense(xg, w, b)
    assert block_fused.counts() == (before[0], before[1] + 2)

    with pytest.raises(RuntimeError, match="no backward"):
        block_fused.dense_epilogue(tclip.matmul_f32(xg, w), b, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        block_fused.layernorm(xg, ln.scale, ln.bias, 1e-5)


def test_wrappers_refuse_other_devices_and_acts():
    acc = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_fused.dense_epilogue(acc, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_fused.layernorm(acc, torch.ones(8, device="meta"), torch.zeros(8, device="meta"), 1e-5)
    with pytest.raises(ValueError, match="unknown act"):
        block_fused.dense_epilogue(torch.zeros(2, 8), act="relu", dtype=torch.float32)


def _model(name):
    cfg = configs.get_config(name)
    return tclip.init_clip(cfg, seed=3, device="cpu").eval(), cfg


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-siglip"])
def test_towers_return_what_the_eager_chain_returns(name, dtype, eager):
    model, cfg = _model(name)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (3, cfg.image_size, cfg.image_size, 3), dtype=np.uint8))
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, cfg.context_length))).long()
    x = _rng_tensor(rng, (3, cfg.vision_seq_len, cfg.vision_width), dtype)
    blk = model.visual.blocks[0]
    with torch.inference_mode():
        got = (tclip.encode_image(model, images, compute_dtype=dtype),
               tclip.encode_text(model, tokens, compute_dtype=dtype), blk(x))
        with eager:
            want = (tclip.encode_image(model, images, compute_dtype=dtype),
                    tclip.encode_text(model, tokens, compute_dtype=dtype), blk(x))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-siglip"])
def test_differentiable_forward_keeps_its_gradients(name, eager):
    """The train step's route: parameters that require grad take the eager
    chain in every dense and LayerNorm, and the contrastive loss's gradients
    equal the eager chain's bit for bit."""
    from clip_retrieval_tpu_torch.parallel.train import clip_contrastive_loss

    model, cfg = _model(name)
    params = [p for p in model.parameters()]
    for p in params:
        p.requires_grad_(True)
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.integers(0, 256, (4, cfg.image_size, cfg.image_size, 3), dtype=np.uint8))
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, cfg.context_length))).long()

    def grads():
        for p in params:
            p.grad = None
        img, txt, scale = tclip.clip_forward(model, images, tokens, attn_impl="xla")
        clip_contrastive_loss(img, txt, scale).backward()
        return [p.grad.clone() if p.grad is not None else None for p in params]

    before = block_fused.counts()
    got = grads()
    fused, eager_calls = block_fused.counts()
    assert fused == before[0] and eager_calls > before[1]
    with eager:
        want = grads()
    assert any(g is not None for g in got)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


# -- the kernels on the card ---------------------------------------------------

# (rows, N) of every dense of the two benchmark cells at batch 256: ViT-L/14's image
# (256 × 257 rows) and text (256 × 77) towers, SigLIP So400m/384's image (256 × 729) and text (256 × 64)
CELL_SHAPES = [(65_792, 1024), (65_792, 4096), (19_712, 768), (19_712, 3072),
               (186_624, 1152), (186_624, 4304), (16_384, 1152), (16_384, 4304)]
LN_SHAPES = [(65_792, 1024), (19_712, 768), (186_624, 1152), (16_384, 1152)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), in f32."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS, ids=["none", "quick_gelu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("rows,n", CELL_SHAPES)
def test_cuda_epilogue_matches_the_eager_chain(rows, n, act):
    """bf16: without an activation bit for bit (bias, cast, residual); with
    one, at most one bf16 ulp off and equal on ≥ 99.9 % of the elements (the
    activation's f32 math may be compiled otherwise than PyTorch's).  Also
    f32 at the first shapes."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(rows + n)
    acc = torch.randn(rows, n, generator=gen, device=dev) * 2.5
    bias = torch.randn(n, generator=gen, device=dev) * 0.5
    for dtype in DTYPES if n <= 1152 or rows == 65_792 else [torch.bfloat16]:
        for res in (None, torch.randn(rows, n, generator=gen, device=dev).to(dtype)):
            launches = block_fused.dense_epilogue.launches
            got = block_fused.dense_epilogue(acc, bias, act=act, residual=res, dtype=dtype)
            torch.cuda.synchronize()
            assert block_fused.dense_epilogue.launches == launches + 1
            want = block_fused.dense_epilogue_reference(acc, bias, act, res, dtype)
            assert got.dtype == dtype and got.shape == want.shape
            if act is None:
                assert torch.equal(got, want), (rows, n, dtype, res is not None)
            elif dtype == torch.bfloat16:
                diff = (got.float() - want.float()).abs()
                assert bool((diff <= _bf16_ulp(want)).all()), (rows, n, act, diff.max().item())
                assert (diff == 0).float().mean().item() >= 0.999
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            del got, want
    # no bias, N % 8 != 0 (the bias read across rows, the scalar tail) and an unaligned residual (scalar route)
    for shape in ((rows // 64, n), (7, 1001)):
        a = acc.reshape(-1)[: shape[0] * shape[1]].reshape(shape)
        unaligned = torch.randn(shape[0] * shape[1] + 1, generator=gen, device=dev).to(torch.bfloat16)[1:]
        for b in (None, torch.randn(shape[1], generator=gen, device=dev)):
            for r in (None, unaligned.reshape(shape)):
                got = block_fused.dense_epilogue(a, b, act=act, residual=r, dtype=torch.bfloat16)
                torch.cuda.synchronize()
                want = block_fused.dense_epilogue_reference(a, b, act, r, torch.bfloat16)
                if act is None:
                    assert torch.equal(got, want), shape
                else:
                    assert bool(((got.float() - want.float()).abs() <= _bf16_ulp(want)).all()), shape


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("rows,w", LN_SHAPES)
def test_cuda_layernorm_within_one_ulp(rows, w, eps):
    """bf16 within one bf16 ulp of `F.layer_norm` in f32 cast back, or 1e-6
    where an output near 0 meets statistics summed in another order (the
    f32 rounding of mean and variance, ~1e-7 of the row's scale); f32 within
    2e-6.  Also the scalar route (W % 8 != 0)."""
    dev = _cuda()
    gen = torch.Generator(device=dev)
    gen.manual_seed(rows + w)
    scale = torch.randn(w, generator=gen, device=dev) * 0.2 + 1
    bias = torch.randn(w, generator=gen, device=dev) * 0.1
    x32 = torch.randn(rows, w, generator=gen, device=dev) * 2 + 0.3
    for dtype in DTYPES:
        x = x32.to(dtype)
        launches = block_fused.layernorm.launches
        got = block_fused.layernorm(x, scale, bias, eps)
        torch.cuda.synchronize()
        assert block_fused.layernorm.launches == launches + 1
        want = block_fused.layernorm_reference(x, scale, bias, eps)
        diff = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            assert bool(((diff <= _bf16_ulp(want)) | (diff <= 1e-6)).all()), (rows, w, diff.max().item())
        else:
            assert diff.max().item() <= 2e-6, (rows, w, diff.max().item())
    x = x32[:64, : w - 3].contiguous().to(torch.bfloat16)
    got = block_fused.layernorm(x, scale[: w - 3].contiguous(), bias[: w - 3].contiguous(), eps)
    want = block_fused.layernorm_reference(x, scale[: w - 3], bias[: w - 3], eps)
    diff = (got.float() - want.float()).abs()
    assert bool(((diff <= _bf16_ulp(want)) | (diff <= 1e-6)).all())


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    acc = torch.randn(64, 256, device=dev)
    bias = torch.randn(256, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        block_fused.dense_epilogue(acc.t(), None, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        block_fused.dense_epilogue(acc.half().float()[:, ::2], None, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        block_fused.dense_epilogue(acc, bias, dtype=torch.float16)
    with pytest.raises(ValueError, match="acc must be"):
        block_fused.dense_epilogue(acc.to(torch.bfloat16), bias, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="residual must be"):
        block_fused.dense_epilogue(acc, bias, residual=acc, dtype=torch.bfloat16)
    x = acc.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        block_fused.layernorm(x.t(), bias[:64].contiguous(), bias[:64].contiguous(), 1e-5)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        block_fused.layernorm(acc.half(), bias, bias, 1e-5)
    with pytest.raises(ValueError, match="width"):
        block_fused.layernorm(torch.zeros(2, 2056, device=dev, dtype=torch.bfloat16),
                              torch.ones(2056, device=dev), torch.zeros(2056, device=dev), 1e-5)
    block_fused.dense_epilogue(acc, bias, act="gelu_tanh", dtype=torch.bfloat16)
    block_fused.layernorm(x, bias, bias, 1e-6)
    torch.cuda.synchronize()  # no fault from the launches above


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-siglip"])
def test_cuda_towers_take_the_kernels(name, eager):
    """Under inference mode every dense and LayerNorm of a tower launches a
    kernel (no eager call), and the bf16 towers stay within the repo's tower
    bar (cosine ≥ 0.999) of the eager chain's f32 towers."""
    dev = _cuda()
    cfg = configs.get_config(name)
    model = tclip.init_clip(cfg, seed=3, device=dev).eval()
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (4, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)).to(dev)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, cfg.context_length))).long().to(dev)
    with torch.inference_mode():
        before = block_fused.counts()
        got = (tclip.encode_image(model, images, compute_dtype=torch.bfloat16),
               tclip.encode_text(model, tokens, compute_dtype=torch.bfloat16))
        torch.cuda.synchronize()
        now = block_fused.counts()
        with eager:
            ref = (tclip.encode_image(model, images, compute_dtype=torch.float32),
                   tclip.encode_text(model, tokens, compute_dtype=torch.float32))
    assert now[1] == before[1] and now[0] > before[0]
    for g, r in zip(got, ref):
        assert F.cosine_similarity(g, r, dim=-1).min().item() >= 0.999

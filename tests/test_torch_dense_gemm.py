"""The towers' dense as one GEMM kernel with its epilogue
(`ops/block_fused.py::dense_gemm`, kernel in `csrc/dense_gemm.cu`) and the
route that chooses it (`block_fused.dense_route`).

On the CPU: the route at every `_dense` shape of the benchmark's cells, at
the small row counts, at unaligned N or K, for what the wrapper refuses, and
for tensor-parallel and differentiable calls (meta tensors seen as on an
H100); the wrapper's plain version is
`dense_epilogue_reference` over `matmul_f32`, bit for bit; `_dense` keeps
the split route on the CPU.  The `cuda`-marked tests hold the kernel to the
plain version on the card at the cells' shapes, ragged edges included, and
its f32 product to an f64 product (`python -m pytest
tests/test_torch_dense_gemm.py -m cuda` on a machine with an NVIDIA GPU and
nvcc).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from clip_retrieval_tpu_torch.models import clip as tclip
from clip_retrieval_tpu_torch.ops import block_fused

ACTS = [None, "quick_gelu", "gelu", "gelu_tanh"]
ACT_IDS = ["none", "quick_gelu", "gelu", "gelu_tanh"]
BF16 = torch.bfloat16

# (M, K, N) of every dense of the three cells at batch 256 (image and text
# towers of SigLIP So400m/384, ViT-L/14 and EVA02-L/14-336; q, k and the
# gate of EVA02's image blocks take other kernels), then the patch
# embeddings (K 588 in rows 592 apart)
CELL_DENSES = [
    (186_624, 1152, 1152), (186_624, 1152, 4304), (186_624, 4304, 1152),
    (16_384, 1152, 1152), (16_384, 1152, 4304), (16_384, 4304, 1152),
    (65_792, 1024, 1024), (65_792, 1024, 4096), (65_792, 4096, 1024),
    (19_712, 768, 768), (19_712, 768, 3072), (19_712, 3072, 768),
    (147_712, 1024, 1024), (147_712, 2736, 1024),
]
PATCHES = [(186_624, 588, 1152), (65_536, 588, 1024), (147_456, 588, 1024)]


H100_SMS = 132


@pytest.fixture
def card(monkeypatch):
    """The route's view of a meta tensor as a tensor on an H100 (132 SMs):
    the cells' shapes are tried without their data."""
    monkeypatch.setattr(block_fused, "_sm_count", lambda device: H100_SMS if device.type == "meta" else None)


def _route(m, n, k, *, lda=None, dtype=BF16, offset=0, residual=False, reduce=False, grad=False):
    """The route of x (m, k) in rows `lda` apart, starting `offset` elements
    into its storage, @ w (k, n) with an f32 bias, as meta tensors."""
    lda = k if lda is None else lda
    x = torch.empty(m * lda + offset, device="meta", dtype=dtype)[offset:].view(m, lda)[:, :k]
    w = torch.empty(k, n, device="meta", dtype=dtype)
    bias = torch.empty(n, device="meta")
    res = torch.empty(m, n, device="meta", dtype=dtype) if residual else None
    return block_fused.dense_route(x, w, bias, res, reduce=reduce, grad=grad)


# -- the route (CPU) ------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", CELL_DENSES)
def test_route_takes_the_gemm_at_every_cell_shape(m, k, n, card):
    assert _route(m, n, k) == "gemm"
    assert _route(m, n, k, residual=True) == "gemm"
    assert _route(m, n, k, reduce=True) == "split"  # the train step's row-parallel products
    assert _route(m, n, k, grad=True) == "split"  # autograd records the call
    assert _route(m, n, k, dtype=torch.float32) == "split"
    assert _route(m, n, k, offset=1) == "split"  # x's data not 16-byte aligned


@pytest.mark.parametrize("m,k,n", PATCHES)
def test_route_of_the_patch_embedding_follows_the_row_stride(m, k, n, card):
    assert _route(m, n, k, lda=592) == "gemm"
    assert _route(m, n, k) == "split"  # rows of 588 bf16 are not 16-byte aligned


@pytest.mark.parametrize("m,k,n", [(1, 4304, 1152), (16, 4304, 1152), (2048, 4304, 1152), (77, 4096, 1024)])
def test_route_keeps_small_row_counts_split(m, k, n, card):
    """A product deeper than `GEMM_DEEP_K` whose tiles fill fewer than the
    card's SMs (the MLP's second product of a few images or captions, K
    4304 or 4096) stays split, where cuBLAS splits K; the same rows take
    the kernel once the tiles fill the card, and at K 1152 or 3072 at any
    row count, as the pooling head's one query row (1 × 1152 → 1152) and
    its 256-row products do."""
    assert _route(m, n, k) == "split"
    tiles_n = -(-n // block_fused.GEMM_TILE)
    filled = -(-H100_SMS // tiles_n) * block_fused.GEMM_TILE  # rows whose tiles fill the SMs
    assert _route(filled, n, k) == "gemm"
    assert _route(filled - block_fused.GEMM_TILE, n, k) == "split"
    assert _route(m, n, 1152) == "gemm"
    assert _route(m, n, block_fused.GEMM_DEEP_K) == "gemm"
    assert _route(m, n, block_fused.GEMM_DEEP_K + 8) == "split"


@pytest.mark.parametrize("k,n", [(1152, 1001), (1150, 1152), (2730, 1024), (1152, 4300)])
def test_route_keeps_unaligned_n_or_k_split(k, n, card):
    assert _route(186_624, n, k) == "split"


def test_route_refuses_what_the_wrapper_refuses(card):
    """The route sends to the kernel only what `dense_gemm` takes: a
    residual that is not contiguous, or not 16-byte aligned, a bias that is
    not f32, or w not contiguous, stays split."""
    x = torch.empty(4096, 1152, device="meta", dtype=BF16)
    w, bias = torch.empty(1152, 1152, device="meta", dtype=BF16), torch.empty(1152, device="meta")
    assert block_fused.dense_route(x, w, bias, torch.empty(4096, 1152, device="meta", dtype=BF16)) == "gemm"
    strided = torch.empty(4096, 1160, device="meta", dtype=BF16)[:, :1152]
    unaligned = torch.empty(4096 * 1152 + 1, device="meta", dtype=BF16)[1:].view(4096, 1152)
    for res in (strided, unaligned):
        assert block_fused.gemm_refusal(x, w, bias, res) is not None
        assert block_fused.dense_route(x, w, bias, res) == "split"
    assert block_fused.dense_route(x, w, bias.to(BF16)) == "split"
    assert block_fused.dense_route(x, w.t(), bias) == "split"
    cpu = torch.zeros(256, 64, dtype=BF16)
    assert block_fused.dense_route(cpu, torch.zeros(64, 64, dtype=BF16)) == "split"  # no card


# -- the plain version (CPU) ----------------------------------------------------


def _rng(rng, shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("with_residual", [False, True], ids=["no_residual", "residual"])
@pytest.mark.parametrize("act", ACTS, ids=ACT_IDS)
def test_plain_version_is_the_split_chain(act, with_residual, with_bias, dtype):
    rng = np.random.default_rng(3 + ACTS.index(act))
    x = _rng(rng, (37, 24), dtype, scale=2.0)
    w = _rng(rng, (24, 40), dtype, scale=0.3)
    bias = _rng(rng, (40,), scale=0.5) if with_bias else None
    res = _rng(rng, (37, 40), dtype) if with_residual else None
    want = block_fused.dense_epilogue_reference(tclip.matmul_f32(x, w), bias, act, res, dtype)
    got = block_fused.dense_gemm(x, w, bias, act=act, residual=res, dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(block_fused.dense_gemm_reference(x, w, bias, act, res, dtype), want)


def test_cpu_dense_takes_the_split_route_and_counts_nothing():
    """On the CPU `_dense` is the split chain (matmul_f32, then the
    epilogue's plain version), whatever its shape: no launch is counted, and
    a padded im2col view gives what its contiguous copy gives."""
    rng = np.random.default_rng(1)
    x = _rng(rng, (2, 5, 592), BF16)[..., :588]
    w, b = _rng(rng, (588, 16), scale=0.05), _rng(rng, (16,))
    before = (block_fused.dense_gemm.launches, block_fused.dense_epilogue.launches)
    got = tclip._dense(x, w, b, act="gelu_tanh")
    assert (block_fused.dense_gemm.launches, block_fused.dense_epilogue.launches) == before
    want = block_fused.dense_epilogue_reference(tclip.matmul_f32(x.contiguous(), w), b, "gelu_tanh", None, BF16)
    assert torch.equal(got, want)


def _denses(cfg, tower: str) -> int:
    """`_dense` calls of one tower's forward: 6 a block (EVA02's image
    blocks 3: q and k take the rotary epilogue, the MLP-in the gate), the
    patch dense, and a pooling head's q, k, v, wo and fc1."""
    if tower == "text":
        return 6 * cfg.text_layers
    per_block = 3 if cfg.rope != "none" else 6
    return per_block * cfg.vision_layers + 1 + (5 if cfg.pool == "map" else 0)


@pytest.mark.parametrize("model", ["test-tiny", "test-tiny-siglip", "test-tiny-eva"])
@pytest.mark.parametrize("route", ["gemm", "split"])
def test_tower_spans_count_gemm_and_split(model, route, monkeypatch):
    """The mapper's `gemm` and `split` counters are the denses of each tower
    that took `dense_gemm` and those that took `dense_epilogue` (launches
    counted as on the card; the route forced, since on the CPU every dense
    is split), and the one-kernel launches count in `fused` too."""
    from clip_retrieval_tpu_torch.inference.mapper import ClipMapper
    from clip_retrieval_tpu_torch.utils import trace

    def counting(fn):
        def wrapped(*args, **kwargs):
            wrapped.launches += 1
            return fn(*args, **kwargs)

        wrapped.launches = fn.launches
        return wrapped

    for name in ("dense_gemm", "dense_epilogue"):
        monkeypatch.setattr(block_fused, name, counting(getattr(block_fused, name)))
    monkeypatch.setattr(block_fused, "dense_route", lambda *args, **kwargs: route)
    m = ClipMapper(enable_image=True, enable_text=True, clip_model=model, batch_size=4, device="cpu")
    cfg = m.bundle.cfg
    batch = {"image_tensor": np.zeros((2, cfg.image_size, cfg.image_size, 3), np.uint8),
             "text_tokens": m.bundle.tokenize(["a cat"] * 2), "image_filename": ["f"] * 2, "text": ["a cat"] * 2}
    before = {s["id"] for s in trace.export()}
    m(batch)
    spans = {s["name"]: s for s in trace.export() if s["id"] not in before}
    for tower in ("image", "text"):
        c = spans[f"mapper.{tower}"]["counters"]
        want = _denses(cfg, tower)
        assert (c["gemm"], c["split"]) == ((want, 0) if route == "gemm" else (0, want)), (tower, c)
        assert c["fused"] == c["gemm"] + c["split"], (tower, c)  # no LayerNorm, rotary or gate launch counted


def test_wrapper_refuses_other_devices_and_acts():
    x = torch.empty(2, 8, device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_fused.dense_gemm(x, torch.empty(8, 8, device="meta", dtype=BF16))
    with pytest.raises(ValueError, match="unknown act"):
        block_fused.dense_gemm(torch.zeros(2, 8, dtype=BF16), torch.zeros(8, 8, dtype=BF16), act="relu")


# -- the kernel on the card -----------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), in f32."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).to(torch.int32))


def _operands(dev, m, k, n, lda, seed, residual):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = (torch.randn(m, lda, generator=gen, device=dev) * 0.5).to(BF16)[:, :k]
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(BF16)
    bias = torch.randn(n, generator=gen, device=dev) * 0.1
    res = torch.randn(m, n, generator=gen, device=dev).to(BF16) if residual else None
    return x, w, bias, res


# (M, K, N, lda): a SigLIP block's products at its image rows (N 4304 and K
# 4304 ragged at the 128-column tile and the 64-deep k-block), ViT-L/14's
# text rows (256·77), EVA02's fc2 (K 2736), a patch embedding (K 588 in rows
# 592 apart) and a tile grid ragged in every direction
KERNEL_SHAPES = [(186_624, 1152, 4304, 1152), (186_624, 4304, 1152, 4304), (19_712, 768, 3072, 768),
                 (147_712, 2736, 1024, 2736), (65_536, 588, 1024, 592), (4_999, 200, 136, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS, ids=ACT_IDS)
@pytest.mark.parametrize("m,k,n,lda", KERNEL_SHAPES)
def test_cuda_kernel_matches_the_plain_version(m, k, n, lda, act):
    """Against the plain version on the card (cuBLAS's f32 product and the
    epilogue's arithmetic).  The two sum each product's K terms in other
    orders (cuBLAS may split K), so their f32 products each lie within
    K·2⁻²³·Σ|x||w| of the exact sum and differ by at most twice that, which
    a sum near zero shows as many ulps of the result.  t = round(acc + b)
    may then differ by that and one bf16 ulp of t; the activation (slope ≤
    ~1.13, and where it flattens, as GELU's tail, an output far smaller than
    t) carries it on, and its rounding and the residual's add add at most
    two bf16 ulps of |out| + |residual|.  The bound is that sum; in practice
    ≥ 99 % of the elements are equal.  Both with and without bias and
    residual."""
    dev = _cuda()
    x, w, bias, res = _operands(dev, m, k, n, lda, m + k + n, residual=True)
    mag = torch.mm(x.abs(), w.abs(), out_dtype=torch.float32)
    for b, r in ((bias, res), (None, None)):
        launches = block_fused.dense_gemm.launches
        got = block_fused.dense_gemm(x, w, b, act=act, residual=r)
        torch.cuda.synchronize()
        assert block_fused.dense_gemm.launches == launches + 1
        acc = torch.mm(x, w, out_dtype=torch.float32)
        want = block_fused.dense_epilogue_reference(acc, b, act, r, BF16)
        assert got.dtype == BF16 and got.shape == (m, n)
        diff = (got.float() - want.float()).abs()
        t = acc if b is None else acc + b
        tol = 1.2 * (2 * k * 2.0 ** -23 * mag + _bf16_ulp(t)) + 2 * _bf16_ulp(
            want.float().abs() + (0 if r is None else r.float().abs()))
        assert bool((diff <= tol).all()), (m, k, n, act, (diff - tol).max().item())
        assert (diff == 0).float().mean().item() >= 0.99
        del got, acc, want, diff, t, tol


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,lda", KERNEL_SHAPES)
def test_cuda_kernel_f32_product_against_f64(m, k, n, lda):
    """The kernel's f32 product (dtype f32) against the f64 product of the
    same bf16 operands, on a slice of rows: each product of two bf16 values
    is exact in f32, so the f32 result differs from the f64 one only by the
    roundings (or the tensor cores' truncations) of the running sums, at
    most K·2⁻²³ of Σ|x||w| per element whatever the order of the sums.  A
    tile or swizzle fault would be off by the order of the sum itself."""
    dev = _cuda()
    x, w, _, _ = _operands(dev, m, k, n, lda, 7 * m + n, residual=False)
    got = block_fused.dense_gemm(x, w, dtype=torch.float32)
    torch.cuda.synchronize()
    rows = torch.arange(0, m, max(1, m // 2048), device=dev)
    want = x[rows].double() @ w.double()
    mag = x[rows].double().abs() @ w.double().abs()
    err = (got[rows].double() - want).abs()
    assert bool((err <= k * 2.0 ** -23 * mag).all()), (err / mag.clamp_min(1e-30)).max().item()
    assert (err / mag.clamp_min(1e-30)).median().item() <= 2.0 ** -20


@pytest.mark.cuda
def test_cuda_dense_routes_and_counts():
    """`_dense` on the card: a large bf16 call takes the kernel (one launch of
    `dense_gemm`, none of `dense_epilogue`), and so does the pooling head's
    one query row; a deep product of few rows (K 4304, 255 rows) the split
    route."""
    dev = _cuda()
    x, w, bias, res = _operands(dev, 8192, 1152, 1152, 1152, 5, residual=True)
    deep_x, deep_w, _, _ = _operands(dev, 255, 4304, 1152, 4304, 6, residual=False)
    w32 = w.float()
    g, s = block_fused.dense_gemm.launches, block_fused.dense_epilogue.launches
    with torch.inference_mode():
        y = tclip._dense(x.reshape(32, 256, 1152), w32, bias, act="gelu_tanh", residual=res.reshape(32, 256, 1152))
        assert (block_fused.dense_gemm.launches, block_fused.dense_epilogue.launches) == (g + 1, s)
        q = tclip._dense(x[:1], w32, bias)
        assert (block_fused.dense_gemm.launches, block_fused.dense_epilogue.launches) == (g + 2, s)
        z = tclip._dense(deep_x, deep_w.float(), bias)
        assert (block_fused.dense_gemm.launches, block_fused.dense_epilogue.launches) == (g + 2, s + 1)
    torch.cuda.synchronize()
    assert y.shape == (32, 256, 1152) and q.shape == (1, 1152) and z.shape == (255, 1152)


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _cuda()
    x = torch.randn(256, 64, device=dev).to(BF16)
    w = torch.randn(64, 64, device=dev).to(BF16)
    with pytest.raises(TypeError, match="bfloat16 operands"):
        block_fused.dense_gemm(x.float(), w.float())
    with pytest.raises(ValueError, match="row stride"):
        block_fused.dense_gemm(torch.randn(256, 68, device=dev).to(BF16)[:, :60], w[:60])
    with pytest.raises(ValueError, match="N a multiple of 8"):
        block_fused.dense_gemm(x, w[:, :60].contiguous())
    with pytest.raises(ValueError, match="f32 product alone"):
        block_fused.dense_gemm(x, w, torch.zeros(64, device=dev), dtype=torch.float32)
    with pytest.raises(ValueError, match="residual must be"):
        block_fused.dense_gemm(x, w, residual=x.float())
    block_fused.dense_gemm(x, w, torch.zeros(64, device=dev), act="gelu_tanh")
    torch.cuda.synchronize()  # no fault from the launch above

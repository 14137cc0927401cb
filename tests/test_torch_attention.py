"""Port's packed attention (kernel K1's plain version) against the JAX package.

Inputs are made with numpy from a seed and go through the JAX Pallas kernel
`flash_attention_packed` (interpret mode on the CPU, as
tests/test_models/test_flash_attention.py runs it), the JAX
`sdpa_reference`, and the port's `flash_attention_packed`, which runs its
plain version for CPU tensors.  Bar: f32, atol 2e-5 and rtol 1e-4, the bar
of the JAX package's own attention tests.  The CUDA kernel itself is held to
its plain version by the `cuda`-marked test, which skips without a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_retrieval_tpu.ops.attention import sdpa_reference as jax_sdpa_reference
from clip_retrieval_tpu.ops.flash import flash_attention_packed as jax_flash_packed
from clip_retrieval_tpu_torch.ops import attention as t_attn
from clip_retrieval_tpu_torch.ops import flash as t_flash

ATOL, RTOL = 2e-5, 1e-4
# (heads, dh, S): B/32|B/16 (12, 64, 50), L/14 (16, 64, 257), text towers
# (8, 64, 77), H/14 (16, 80, 257), g/14 (16, 88, 257)
GEOMETRIES = [(12, 64, 50), (16, 64, 257), (8, 64, 77), (16, 80, 257), (16, 88, 257)]
# the ragged edges of the kernel's 16-row / 16-key tiling: one row, one full
# strip, one row past a strip, one past a 64-key tile, one past two
EDGES = [(4, 64, s) for s in (1, 16, 17, 65, 129)]


def _packed_inputs(heads, dh, seq, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, seq, heads * dh)).astype(np.float32) for _ in range(3)]


def _split(x, heads):  # numpy (B, S, W) → (B, H, S, dh)
    b, s, w = x.shape
    return x.reshape(b, s, heads, w // heads).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,dh,seq", GEOMETRIES + EDGES)
def test_packed_matches_jax(heads, dh, seq, causal):
    q, k, v = _packed_inputs(heads, dh, seq)
    before = t_flash.flash_attention_packed.launches
    got = t_attn.sdpa_packed(*map(torch.from_numpy, (q, k, v)), heads, causal=causal).numpy()
    assert t_flash.flash_attention_packed.launches == before  # CPU tensors: plain version, no launch

    pallas = np.asarray(jax_flash_packed(*map(jnp.asarray, (q, k, v)), heads, causal=causal))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    b, s, w = q.shape
    ref = np.asarray(jax_sdpa_reference(*(jnp.asarray(_split(x, heads)) for x in (q, k, v)), causal=causal))
    np.testing.assert_allclose(got, ref.transpose(0, 2, 1, 3).reshape(b, s, w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bf16_logits", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_reference_matches_jax(causal, bf16_logits):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 4, 50, 64)).astype(np.float32) for _ in range(3))
    got = t_attn.sdpa_reference(*map(torch.from_numpy, (q, k, v)), causal=causal, bf16_logits=bf16_logits)
    ref = jax_sdpa_reference(*map(jnp.asarray, (q, k, v)), causal=causal, bf16_logits=bf16_logits)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_plain_version_matches_packed_bf16_semantics():
    """bf16 inputs: the plain version computes in f32 and returns bf16, like
    the JAX kernel (f32 logits/softmax, probabilities cast to v's dtype)."""
    q, k, v = _packed_inputs(4, 16, 33, seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = t_flash.flash_attention_packed(tq, tk, tv, 4, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_flash_packed(jq, jk, jv, 4, causal=True, group=4).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2, rtol=1e-2)


def test_wrapper_rejects_other_devices():
    q = torch.empty(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_flash.flash_attention_packed(q, q, q, 1)


def test_kernel_build_refuses_outside_a_checkout(monkeypatch, tmp_path):
    from clip_retrieval_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "CHECKOUT", tmp_path)
    with pytest.raises(RuntimeError, match="only from a checkout"):
        cuda_build.load_library("flash_packed")
    assert not (tmp_path / "build").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernel_matches_plain_version(dtype):
    """The kernel on the card against its plain version on the same inputs,
    tower geometries and the tiling's ragged edges: bf16 max abs ≤ 2e-2
    against the f32 plain result, f32 atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    cases = [(12, 64, 50, False), (16, 88, 257, False), (16, 64, 577, False), (12, 64, 77, True)]
    cases += [(heads, dh, seq, causal) for heads, dh, seq in EDGES for causal in (False, True)]
    for heads, dh, seq, causal in cases:
        q, k, v = (torch.from_numpy(x).cuda().to(dt) for x in _packed_inputs(heads, dh, seq, b=4))
        before = t_flash.flash_attention_packed.launches
        got = t_flash.flash_attention_packed(q, k, v, heads, causal=causal)
        torch.cuda.synchronize()
        assert t_flash.flash_attention_packed.launches == before + 1
        ref = t_flash.flash_attention_packed_reference(q.float(), k.float(), v.float(), heads, causal=causal)
        err = (got.float() - ref).abs().max().item()
        assert err <= (2e-2 if dt == torch.bfloat16 else 1e-4), (heads, dh, seq, causal, err)


def _aligned(n: int = 4) -> list[int]:
    return [0x7F0000 + 256 * i for i in range(n)]


@pytest.mark.parametrize("dtype,dh,ptrs,want", [
    (torch.bfloat16, 64, _aligned(), "wgmma"),        # every CLIP tower's dh, as before
    (torch.bfloat16, 32, _aligned(), "wgmma"),
    (torch.bfloat16, 72, _aligned(), "wgmma"),        # SigLIP So400m
    (torch.bfloat16, 80, _aligned(), "wgmma"),        # ViT-H/14's image tower
    (torch.bfloat16, 88, _aligned(), "wgmma"),        # ViT-g/14's image tower
    (torch.bfloat16, 128, _aligned(), "wgmma"),
    (torch.bfloat16, 72, _aligned()[:3] + [0x7F0002], "mma_sync"),  # one pointer off 16 bytes
    (torch.bfloat16, 20, _aligned(), "mma_sync"),     # dh % 8 != 0: element loads
    (torch.float32, 72, _aligned(), "f32"),
    (torch.float32, 64, _aligned(), "f32"),
])
def test_kernel_route_rule(dtype, dh, ptrs, want):
    assert t_flash.kernel_route(dtype, dh, ptrs) == want


@pytest.mark.parametrize("entry", ["packed", "bhsd"])
@pytest.mark.parametrize("dtype,dh,offset,want", [
    (torch.bfloat16, 72, 0, "wgmma"), (torch.bfloat16, 64, 0, "wgmma"),
    (torch.bfloat16, 72, 1, "mma_sync"), (torch.float32, 72, 0, "f32"),
])
def test_wrappers_hand_the_kernel_its_route(monkeypatch, entry, dtype, dh, offset, want):
    """The wrappers pass vec = 1 exactly for the wgmma route and count the
    launch under the route (the kernel stubbed: CPU tensors posing as CUDA)."""
    from clip_retrieval_tpu_torch.ops import cuda_build

    calls = []

    def launch(counter, device, where, *args, route=None):
        calls.append((args, route))
        counter.launches += 1
        counter.launches_by_route[route] += 1

    monkeypatch.setattr(cuda_build, "route", lambda name, *tensors: "cuda")
    kernel = t_flash._PACKED if entry == "packed" else t_flash._BHSD
    monkeypatch.setattr(kernel, "launch", launch)
    shape = (2, 65, 3 * dh) if entry == "packed" else (2, 3, 65, dh)
    n = int(np.prod(shape))
    q, k, v = (torch.zeros(n + 8, dtype=dtype)[offset:offset + n].view(shape) for _ in range(3))
    wrapper = t_flash.flash_attention_packed if entry == "packed" else t_flash.flash_attention
    before = dict(wrapper.launches_by_route)
    if entry == "packed":
        wrapper(q, k, v, 3)
    else:
        wrapper(q, k, v)
    (args, route), = calls
    assert route == want and args[-1] == int(want == "wgmma")
    assert wrapper.launches_by_route[want] == before[want] + 1


# The wgmma route above dh 64 (two column panels): SigLIP So400m (72), ViT-H/14
# (80), ViT-g/14 (88) and the widest head (128); the image (729), a ragged
# (257) and the text (64) sequence lengths.
WIDE = [(dh, seq) for dh in (72, 80, 88, 128) for seq in (64, 257, 729)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh,seq", WIDE)
def test_cuda_wide_heads_take_the_wgmma_route(dh, seq, causal):
    """K1 on the wgmma route at dh above 64 against its plain version: the
    bf16 bar of `test_cuda_kernel_matches_plain_version`, one launch counted
    under `wgmma`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    heads = 4
    q, k, v = (torch.from_numpy(x).cuda().bfloat16() for x in _packed_inputs(heads, dh, seq, b=3, seed=dh + seq))
    before = t_flash.flash_attention_packed.launches_by_route["wgmma"]
    got = t_flash.flash_attention_packed(q, k, v, heads, causal=causal)
    torch.cuda.synchronize()
    assert t_flash.flash_attention_packed.launches_by_route["wgmma"] == before + 1
    ref = t_flash.flash_attention_packed_reference(q.float(), k.float(), v.float(), heads, causal=causal)
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2, (dh, seq, causal, err)


def _off_by_one_element(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = buf[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_unaligned_wide_heads_take_the_mma_sync_route(causal):
    """dh 72 with pointers off 16 bytes stays on the mma.sync route, right."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    heads, dh, seq = 4, 72, 257
    q, k, v = (_off_by_one_element(torch.from_numpy(x).cuda().bfloat16()) for x in _packed_inputs(heads, dh, seq, b=3))
    before = t_flash.flash_attention_packed.launches_by_route["mma_sync"]
    got = t_flash.flash_attention_packed(q, k, v, heads, causal=causal)
    torch.cuda.synchronize()
    assert t_flash.flash_attention_packed.launches_by_route["mma_sync"] == before + 1
    ref = t_flash.flash_attention_packed_reference(q.float(), k.float(), v.float(), heads, causal=causal)
    assert (got.float() - ref).abs().max().item() <= 2e-2


def test_ab_flash_reads_ptxas_and_bounds():
    """tools/ab_flash.py: registers, spills and C7520 warnings by kernel and
    template arguments (the DP-64 kernel and a `wide` instance), and the
    bound at SigLIP's image shape (products: 6.27e11 FLOP at 989 TFLOP/s)."""
    from clip_retrieval_tpu_torch.tools import ab_flash

    wide = "_ZN12_GLOBAL__N_14wide18flash_wgmma_kernelILi80EEEvP13__nv_bfloat16NS_6LayoutEifiiNS0_4MapsE"
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_wgmma_kernelEPK13__nv_bfloat16S2_S2_"
        "PS0_NS_6LayoutEifi' for 'sm_90a'",
        "ptxas info    : Used 128 registers, 0 bytes smem",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"ptxas info    : Compiling entry function '{wide}' for 'sm_90a'",
        "ptxas info    : Used 127 registers",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas warning : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to "
        f"insufficient register resources for the wgmma pipeline in the function '{wide}'",
    ])
    report = ab_flash.ptxas_report(log)
    assert report["flash_wgmma_kernel"] == {"registers": 128, "spill_stores": 0, "spill_loads": 0}
    assert report["flash_wgmma_kernelILi80E"]["registers"] == 127
    assert report["flash_wgmma_kernelILi80E"]["spill_stores"] == 8
    assert report["flash_wgmma_kernelILi80E"]["warnings"][0].startswith("(C7520)")
    assert abs(ab_flash.bound_ms(256, 729, 16, 72, False) - 0.6339) < 1e-4
    assert abs(ab_flash.bound_ms(256, 257, 16, 64, False) - 0.1609) < 1e-4  # bytes bound the ViT-L/14 shape

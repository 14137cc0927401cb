"""The unpacked attention entry `ops/attention.py::sdpa` and kernel K2
(`ops/flash.py::flash_attention`) against the JAX package's, on the CPU.

On CPU tensors `sdpa(impl='auto'|'flash')` runs K2's plain version; it is
held to the JAX Pallas `flash_attention` (interpret mode on the CPU) and to
`sdpa_reference` at the reference's f32 bar, atol 2e-5 and rtol 1e-4
(`tests/test_models/test_flash_attention.py:26,51`), including Sq ≠ Sk.
The `cuda`-marked test holds the kernel to its plain version on the card at
K1's bars.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_retrieval_tpu.ops import attention as j_attn
from clip_retrieval_tpu.ops.flash import flash_attention as jax_flash
from clip_retrieval_tpu_torch.ops import attention as t_attn
from clip_retrieval_tpu_torch.ops import flash as t_flash


def _inputs(b, h, sq, sk, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, sk, dh)).astype(np.float32) for _ in range(2))
    return q, k, v


SHAPES = [(2, 4, 50, 50, 64), (1, 3, 77, 77, 64), (2, 2, 40, 57, 80), (1, 2, 57, 33, 64)]
# the ragged edges of the kernel's 16-row / 16-key tiling, Sq = Sk and Sq != Sk
EDGES = [(1, 2, s, s, 64) for s in (1, 16, 17, 65, 129)] + [(1, 2, 1, 257, 64), (1, 2, 257, 1, 64),
                                                             (1, 2, 77, 257, 64)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES + EDGES)
@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_sdpa_matches_jax_flash_and_reference(shape, causal, impl):
    q, k, v = _inputs(*shape)
    got = t_attn.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, impl=impl).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jax_flash(jq, jk, jv, causal=causal)), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(j_attn.sdpa_reference(jq, jk, jv, causal=causal)), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "xla_bf16"])
def test_sdpa_plain_routes_match_jax(impl):
    q, k, v = _inputs(2, 3, 50, 50, 64, seed=1)
    got = t_attn.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, impl=impl).numpy()
    want = np.asarray(j_attn.sdpa(*(jnp.asarray(a) for a in (q, k, v)), causal=True, impl=impl))
    tol = 2e-5 if impl == "xla" else 2e-2  # bf16 logits round alike, not at the same points
    np.testing.assert_allclose(got, want, atol=tol, rtol=1e-4 if impl == "xla" else 2e-2)


def test_sdpa_routes_auto_through_the_k2_wrapper(monkeypatch):
    calls = []
    real = t_flash.flash_attention
    monkeypatch.setattr(t_flash, "flash_attention", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 10, 12, 16))
    t_attn.sdpa(q, k, v, causal=True)
    t_attn.sdpa(q, k, v, impl="xla")
    assert calls == [{"causal": True}]
    with pytest.raises(ValueError, match="impl must be"):
        t_attn.sdpa(q, k, v, impl="pallas")


def test_plain_version_keeps_bf16_semantics():
    """bf16 inputs: f32 logits and softmax, probabilities cast to bf16 before
    P·V, output in bf16 — the JAX kernel's casting points."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 2, 20, 20, 32, seed=2))
    got = t_flash.flash_attention_reference(q, k, v)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_flash(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))))
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), atol=2e-2)


def test_wrapper_rejects_other_devices():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_flash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        t_flash.flash_attention(q, k.to("meta"), v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernel_matches_plain_version(dtype):
    """K2 on the card against its plain version on the same inputs: bf16 max
    abs ≤ 2e-2 against the f32 plain result, f32 atol 1e-4; Sq ≠ Sk and the
    tiling's ragged edges too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    for b, h, sq, sk, dh in [(4, 12, 50, 50, 64), (4, 16, 257, 257, 88), (2, 12, 77, 77, 64), (2, 4, 57, 200, 64),
                             *EDGES]:
        for causal in (False, True):
            q, k, v = (torch.from_numpy(a).cuda().to(dt) for a in _inputs(b, h, sq, sk, dh))
            before = t_flash.flash_attention.launches
            got = t_flash.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert t_flash.flash_attention.launches == before + 1
            ref = t_flash.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
            err = (got.float() - ref).abs().max().item()
            assert err <= (2e-2 if dt == torch.bfloat16 else 1e-4), (b, h, sq, sk, dh, causal, err)


# K2 on the wgmma route above dh 64: Sq = Sk at the towers' lengths and a
# ragged key count (Sk ≠ Sq, neither a multiple of 64).
WIDE = [(dh, sq, sk) for dh in (72, 80, 88, 128) for sq, sk in ((64, 64), (257, 257), (729, 729), (100, 729))]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh,sq,sk", WIDE)
def test_cuda_wide_heads_take_the_wgmma_route(dh, sq, sk, causal):
    """K2 at dh above 64 against its plain version (K1's bf16 bar), one launch
    counted under `wgmma`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).cuda().bfloat16() for a in _inputs(2, 3, sq, sk, dh, seed=dh + sk))
    before = t_flash.flash_attention.launches_by_route["wgmma"]
    got = t_flash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert t_flash.flash_attention.launches_by_route["wgmma"] == before + 1
    ref = t_flash.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2, (dh, sq, sk, causal, err)

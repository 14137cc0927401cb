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

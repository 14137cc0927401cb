"""Kernel K4 (`ops/adc_scan.py`): its plain version on the CPU, the kernel on
the card.

On the CPU the wrapper runs `adc_scan_reference`.  It is held to an exact
numpy gather-sum (atol 1e-5), to the order of its own sums (sub-quantizer
order, bit for bit, which is what the CUDA kernel repeats), and to the JAX
Pallas kernel in interpret mode at that kernel's bf16-LUT bar (rtol/atol
2e-2, `tests/test_index/test_adc_pallas.py:51-53`).  The `cuda`-marked test
holds the kernel to the plain version on the card: bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_retrieval_tpu.ops.adc_scan import adc_scan as jax_adc_scan
from clip_retrieval_tpu_torch.ops import adc_scan as k4

C = k4.CHUNK


def _case(m, b, nblocks=5, seed=0):
    """Codes, LUT and a worklist with nvalid 0, partial and full chunks,
    repeated blocks and owners out of order."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nblocks * C, m)).astype(np.uint8)
    lut = rng.normal(size=(b, m, 256)).astype(np.float32)
    blocks = np.array([0, 3, 3, nblocks - 1, 1, 0, 2], np.int32)
    nvalid = np.array([C, 0, 77, C, 1, 128, 50], np.int32)
    owner = (np.array([0, 0, 1, 1, 2, 2, 0]) % b).astype(np.int32)
    coarse = rng.normal(size=(7,)).astype(np.float32)
    return codes, lut, blocks, nvalid, owner, coarse


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _numpy_gather_sum(codes, lut, blocks, nvalid, owner, coarse):
    out = np.full((len(blocks), C), -np.inf)
    m = codes.shape[1]
    for i, (blk, nv, own) in enumerate(zip(blocks, nvalid, owner)):
        rows = codes[blk * C : (blk + 1) * C].astype(np.int64)
        s = lut[own].astype(np.float64)[np.arange(m)[None, :], rows].sum(1) + coarse[i]
        out[i, :nv] = s[:nv]
    return out


@pytest.mark.parametrize("m,b", [(8, 1), (8, 3), (64, 4), (96, 2)])
def test_plain_version_matches_numpy_gather_sum(m, b):
    case = _case(m, b, seed=m + b)
    got = k4.adc_scan(*_torch(case)).numpy()
    want = _numpy_gather_sum(*case)
    assert got.shape == (7, C) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


def test_plain_version_adds_in_sub_quantizer_order():
    """acc = 0; acc += lut[m][code_m] for m in order, in f32; then + coarse:
    the order the CUDA kernel repeats, so the two are bit-identical."""
    codes, lut, blocks, nvalid, owner, coarse = _case(24, 3, seed=9)
    got = k4.adc_scan(*_torch((codes, lut, blocks, nvalid, owner, coarse))).numpy()
    for i in range(len(blocks)):
        rows = codes[blocks[i] * C : (blocks[i] + 1) * C]
        acc = np.zeros(C, np.float32)
        for mm in range(codes.shape[1]):
            acc = acc + lut[owner[i], mm, rows[:, mm]]
        acc = acc + coarse[i]
        np.testing.assert_array_equal(got[i, : nvalid[i]], acc[: nvalid[i]])


def test_plain_version_matches_jax_pallas_interpret():
    m, b = 8, 4
    codes, lut, blocks, nvalid, owner, coarse = _case(m, b, nblocks=4, seed=1)
    blocks, nvalid, owner, coarse = blocks[:4], nvalid[:4], owner[:4], coarse[:4]  # interpret mode is slow
    lut_t = np.ascontiguousarray(lut.transpose(2, 1, 0).reshape(256 * m, b))  # row v·M+m = lut[b][m][v]
    want = np.asarray(jax_adc_scan(jnp.asarray(codes), jnp.asarray(lut_t), jnp.asarray(blocks), jnp.asarray(nvalid),
                                   jnp.asarray(owner), jnp.asarray(coarse), chunk=C, interpret=True))
    got = k4.adc_scan(*_torch((codes, lut, blocks, nvalid, owner, coarse))).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-2, atol=2e-2)


def test_wrapper_rejects_other_devices():
    args = _torch(_case(8, 2))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        k4.adc_scan(*meta)
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="different devices"):
        k4.adc_scan(*args)


def test_kernel_checks_shapes_and_types():
    codes, lut, blocks, nvalid, owner, coarse = _torch(_case(8, 2))
    k4._check(codes, lut, blocks, nvalid, owner, coarse)
    with pytest.raises(ValueError, match="codes must be"):
        k4._check(codes[:100], lut, blocks, nvalid, owner, coarse)
    with pytest.raises(ValueError, match="lut must be"):
        k4._check(codes, lut[:, :4], blocks, nvalid, owner, coarse)
    with pytest.raises(TypeError, match="int32"):
        k4._check(codes, lut, blocks.long(), nvalid, owner, coarse)
    with pytest.raises(ValueError, match="contiguous"):
        k4._check(codes, lut.transpose(1, 2).contiguous().transpose(1, 2), blocks, nvalid, owner, coarse)


@pytest.mark.cuda
def test_cuda_kernel_bit_identical_to_plain_version():
    """K4 on the card against its plain version at M ∈ {8, 64, 96, 192, 256}
    × B ∈ {1, 3, 32, 128}: max abs err 0 and equal −inf sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for m in (8, 64, 96, 192, 256):
        for b in (1, 3, 32, 128):
            args = [a.cuda() for a in _torch(_case(m, b, seed=m * b))]
            before = k4.adc_scan.launches
            got = k4.adc_scan(*args)
            torch.cuda.synchronize()
            assert k4.adc_scan.launches == before + 1
            assert torch.equal(got, k4.adc_scan_reference(*args)), (m, b)

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
from clip_retrieval_tpu_torch.tools import ab_adc

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


def _served_case(m, b, per_owner=48, nblocks=40, seed=0):
    """The served layout: each owner's budget of `per_owner` chunks, in
    owner order, its list chunks first (full, the last one partial) and an
    empty tail (nvalid 0, block 0) after them, as `ivfpq._worklist` builds
    it."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nblocks * C, m)).astype(np.uint8)
    lut = rng.normal(size=(b, m, 256)).astype(np.float32)
    blocks, nvalid = [], []
    for q in range(b):
        rows = int(rng.integers(0, per_owner * C // 2 + 1)) if q else per_owner * C  # owner 0: no tail
        n = -(-rows // C)
        blocks += list(rng.integers(0, nblocks, n)) + [0] * (per_owner - n)
        nvalid += [min(C, rows - i * C) for i in range(n)] + [0] * (per_owner - n)
    owner = np.repeat(np.arange(b), per_owner).astype(np.int32)
    coarse = rng.normal(size=(b * per_owner,)).astype(np.float32)
    return codes, lut, np.array(blocks, np.int32), np.array(nvalid, np.int32), owner, coarse


def _edge_cases(m, seed=0):
    """The edges of the kernel's work split, as (label, case): NC = 1; NC
    below the SM count; one owner's run over many blocks' spans; spans that
    begin mid-owner (7 owners over 1001 chunks); nvalid 0 everywhere; the
    served layout with empty tails."""
    rng = np.random.default_rng(seed)
    nblocks = 12
    codes = rng.integers(0, 256, (nblocks * C, m)).astype(np.uint8)

    def case(nc, b, nvalid=None):
        lut = rng.normal(size=(b, m, 256)).astype(np.float32)
        blocks = rng.integers(0, nblocks, nc).astype(np.int32)
        nv = rng.integers(0, C + 1, nc).astype(np.int32) if nvalid is None else nvalid
        owner = (np.arange(nc) * b // nc).astype(np.int32)
        return codes, lut, blocks, nv, owner, rng.normal(size=(nc,)).astype(np.float32)

    return [("NC=1", case(1, 1)), ("NC=100", case(100, 3)), ("one owner, 3000 chunks", case(3000, 1)),
            ("7 owners, 1001 chunks", case(1001, 7)), ("nvalid 0", case(777, 3, np.zeros(777, np.int32))),
            ("served layout", _served_case(m, 4, per_owner=512, seed=seed))]


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


@pytest.mark.parametrize("m,b", [(16, 3), (64, 5)])
def test_plain_version_matches_numpy_gather_sum_on_the_served_layout(m, b):
    """A long owner-sorted worklist: many chunks per owner, list chunks then
    an empty tail, as the device route builds it."""
    case = _served_case(m, b, seed=m + b)
    got = k4.adc_scan(*_torch(case)).numpy()
    want = _numpy_gather_sum(*case)
    assert got.shape == (b * 48, C)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[case[3] == 0]).all() and (case[3] == 0).sum() > 0
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


@pytest.mark.parametrize("m,b", [(16, 3), (64, 2)])
def test_yardstick_and_bound_of_the_ab_tool(m, b):
    """`ab_adc.bag_inputs` makes `F.embedding_bag` compute the kernel's sums
    (before the mask and the coarse term), and `k4_bound` counts the valid
    rows' bytes and lookups."""
    codes, lut, blocks, nvalid, owner, coarse = args = _torch(_served_case(m, b, seed=7))
    assert ab_adc.bag_check(args, *ab_adc.bag_inputs(args)) <= 1e-5
    bound = ab_adc.k4_bound(args, 1.98e9)
    rows = int(nvalid.sum())
    assert bound["valid_rows"] == rows and bound["lookups"] == rows * m
    assert bound["bytes"] == rows * m + b * m * 256 * 4 + len(blocks) * (16 + 128 * 4)
    assert bound["bound_ms"] == max(bound["bytes_ms"], bound["lookups_ms"])


def test_ab_tool_reads_ptxas_reports():
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119adc_resident_kernelILi16EEEvPKhxPKf' for "
           "'sm_90a'\nptxas info    : Function properties for x\n    8 bytes stack frame, 8 bytes spill stores, 8 "
           "bytes spill loads\nptxas info    : Used 80 registers, used 1 barriers, 400 bytes cmem[0]\n")
    assert ab_adc.ptxas_report(log) == {"adc_resident_kernel<16>": {"spill_stores": 8, "spill_loads": 8,
                                                                    "registers": 80, "static_smem": 0}}


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


@pytest.mark.cuda
def test_cuda_kernel_bit_identical_on_the_work_split_edges():
    """K4 on the card against its plain version on the edges of its work
    split (`_edge_cases`) at M ∈ {8, 16, 64, 96, 256}, and with codes at 4-
    and 1-byte alignment (the narrower load routes): bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for m in (8, 16, 64, 96, 256):
        for label, case in _edge_cases(m, seed=m):
            args = [a.cuda() for a in _torch(case)]
            assert torch.equal(k4.adc_scan(*args), k4.adc_scan_reference(*args)), (m, label)
        codes, *rest = [a.cuda() for a in _torch(_edge_cases(m, seed=m)[3][1])]
        for off in (4, 1):
            buf = torch.empty(codes.numel() + 16, dtype=torch.uint8, device="cuda")
            shifted = buf[off : off + codes.numel()].view(codes.shape)
            shifted.copy_(codes)
            assert shifted.data_ptr() % 16 == off
            assert torch.equal(k4.adc_scan(shifted, *rest), k4.adc_scan_reference(codes, *rest)), (m, off)

"""Port's int8 search ops and kernel K3's plain version against the JAX package.

Inputs are made with numpy from a seed.  K3's plain version
(`int8_gather_scan` on CPU tensors) is held to the JAX Pallas kernel
`int8_gather_scan(..., interpret=True)` on the shapes of
tests/test_index/test_int8scan_pallas.py: bit-identical, because the int32
sums are exact and both dequantize with the same two f32 roundings.
`quantize_rows_device` and `int8_topk` are bit-identical too; `topk_ip` and
`topk_merge` give the same ids with scores within 1e-6 (f32 sums of fp16
products, summed in another order).  The CUDA kernel itself is held to its
plain version by the `cuda`-marked test, which skips without a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_retrieval_tpu.ops import int8mm as j_int8mm
from clip_retrieval_tpu.ops import topk as j_topk
from clip_retrieval_tpu.ops.int8scan import int8_gather_scan as jax_scan
from clip_retrieval_tpu_torch.ops import int8mm, int8scan, topk


def _mk(nchunks=12, lc=8, d=32, b=4, seed=0):
    """The chunk image of tests/test_index/test_int8scan_pallas.py::_mk, with
    chunk nchunks-1 made all padding (the index's dedicated padding chunk)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-127, 127, (nchunks, lc, d)).astype(np.int8)
    scales = rng.uniform(0.5, 1.5, (nchunks, lc)).astype(np.float32)
    pos = rng.integers(0, 10_000, (nchunks, lc)).astype(np.int32)
    mask = rng.uniform(size=(nchunks, lc)) < 0.2
    mask[-1] = True
    scales[mask] = 0.0
    pos[mask] = -1
    q = rng.normal(size=(b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return rows, scales, pos, q


@pytest.mark.parametrize("u", [1, 5, 12, 20])
def test_plain_version_bit_identical_to_pallas_kernel(u):
    rows, scales, pos, q = _mk()
    rng = np.random.default_rng(u)
    sel = rng.choice(rows.shape[0], size=u, replace=True).astype(np.int32)
    sel[-1] = rows.shape[0] - 1  # every selection ends on the all-padding chunk
    qq, q_scale = j_int8mm.quantize_rows_device(jnp.asarray(q))
    want = np.asarray(
        jax_scan(qq, q_scale, *(jnp.asarray(a) for a in (rows, scales, pos, sel)), interpret=True)
    )
    before = int8scan.int8_gather_scan.launches
    got = int8scan.int8_gather_scan(
        torch.from_numpy(np.array(qq)), torch.from_numpy(np.array(q_scale)),
        *(torch.from_numpy(a) for a in (rows, scales, pos, sel)),
    ).numpy()
    assert int8scan.int8_gather_scan.launches == before  # CPU tensors: plain version, no launch
    assert got.shape == (4, u * 8) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[:, -8:]).all()


def test_quantize_rows_matches_jax():
    """Device and host quantizers against their JAX counterparts, bit for
    bit (the JAX device scale is max|x| times f32(1/127): XLA folds the
    division; the host function divides)."""
    x = np.random.default_rng(1).normal(size=(4096, 48)).astype(np.float32)
    x[3] = 0.0  # the 1e-10 floor
    jq, js = j_int8mm.quantize_rows_device(jnp.asarray(x))
    tq, ts = int8mm.quantize_rows_device(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    hq, hs = int8mm.quantize_rows(x)
    jhq, jhs = j_int8mm.quantize_rows(x)
    np.testing.assert_array_equal(hq, jhq)
    np.testing.assert_array_equal(hs, jhs)


def test_int8_topk_matches_jax():
    rng = np.random.default_rng(2)
    db = rng.normal(size=(500, 64)).astype(np.float32)
    dbq, dbs = int8mm.quantize_rows(db)
    q = rng.normal(size=(5, 64)).astype(np.float32)
    jv, ji = j_int8mm.int8_topk(jnp.asarray(q), jnp.asarray(dbq), jnp.asarray(dbs), 10)
    tv, ti = int8mm.int8_topk(torch.from_numpy(q), torch.from_numpy(dbq), torch.from_numpy(dbs), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_topk_ip_and_merge_match_jax():
    rng = np.random.default_rng(3)
    db = rng.normal(size=(300, 32)).astype(np.float32)
    db = (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float16)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jv, ji = j_topk.topk_ip(jnp.asarray(q), jnp.asarray(db), 7)
    tv, ti = topk.topk_ip(torch.from_numpy(q), torch.from_numpy(db), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)

    jv2, ji2 = j_topk.topk_ip(jnp.asarray(q), jnp.asarray(db[150:]), 7)
    tv2, ti2 = topk.topk_ip(torch.from_numpy(q), torch.from_numpy(db[150:]), 7)
    jm = j_topk.topk_merge(jv, ji, jv2, ji2 + 150, 7)
    tm = topk.topk_merge(tv, ti, tv2, ti2 + 150, 7)
    np.testing.assert_array_equal(tm[1].numpy(), np.asarray(jm[1]))
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), atol=1e-6, rtol=0)


def _torch_inputs(b=4, d=32):
    rows, scales, pos, q = _mk(b=b, d=d)
    qq, qs = int8mm.quantize_rows_device(torch.from_numpy(q))
    sel = torch.tensor([0, 3, 11], dtype=torch.int32)
    return [qq, qs, *(torch.from_numpy(a) for a in (rows, scales, pos)), sel]


@pytest.mark.parametrize(
    "arg,bad,err",
    [
        (0, lambda t: t.float(), TypeError),  # qq not int8
        (2, lambda t: t.int(), TypeError),  # rows not int8
        (4, lambda t: t.long(), TypeError),  # pos not int32
        (5, lambda t: t.long(), TypeError),  # chunk_sel not int32
        (1, lambda t: t[:2], ValueError),  # q_scale not (B,)
        (3, lambda t: t[:, :4], ValueError),  # scales not (nchunks, Lc)
        (2, lambda t: t.transpose(1, 2), ValueError),  # rows not (nchunks, Lc, d)
        (2, lambda t: t[:, :, :16].contiguous(), ValueError),  # rows' d differs from qq's
        (0, lambda t: t.t().contiguous().t(), ValueError),  # not contiguous
    ],
)
def test_kernel_input_checks_raise(arg, bad, err):
    """What the CUDA path checks before a launch (`_check`)."""
    args = _torch_inputs()
    int8scan._check(*args)  # the good inputs pass
    args[arg] = bad(args[arg])
    with pytest.raises(err):
        int8scan._check(*args)


def test_kernel_checks_bound_d():
    args = _torch_inputs(d=int8scan.MAX_D + 16)
    with pytest.raises(ValueError, match="not supported"):
        int8scan._check(*args)


def test_wrapper_rejects_other_and_mixed_devices():
    args = [t.to("meta") for t in _torch_inputs()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        int8scan.int8_gather_scan(*args)
    mixed = _torch_inputs()
    mixed[2] = mixed[2].to("meta")
    with pytest.raises(ValueError, match="different devices"):
        int8scan.int8_gather_scan(*mixed)


def test_f32_int8_product_refuses_inexact_settings(monkeypatch):
    """Off the CPU the plain int8 product runs in f32: it raises past the
    d bound where f32 sums stop being exact, and when TF32 is allowed."""
    a = torch.empty(2, int8mm.EXACT_F32_MAX_D + 1, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="exact only"):
        int8mm.int8_matmul_nt(a, a)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    b = torch.empty(2, 768, dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="TF32"):
        int8mm.int8_matmul_nt(b, b)


@pytest.mark.cuda
def test_cuda_kernel_bit_identical_to_plain_version():
    """The kernel on the card against its plain version on the same inputs,
    B ∈ {1, 3, 17, 32, 64}, d ∈ {32, 768}, Lc ∈ {8, 256}: bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for b in (1, 3, 17, 32, 64):
        for lc, d in ((8, 32), (256, 768)):
            rows, scales, pos, q = _mk(lc=lc, d=d, b=b, seed=b)
            qq, qs = int8mm.quantize_rows_device(torch.from_numpy(q).cuda())
            dev = [torch.from_numpy(a).cuda() for a in (rows, scales, pos)]
            sel = torch.tensor([11, 0, 3, 3, 7], dtype=torch.int32, device="cuda")
            before = int8scan.int8_gather_scan.launches
            got = int8scan.int8_gather_scan(qq, qs, *dev, sel)
            torch.cuda.synchronize()
            assert int8scan.int8_gather_scan.launches == before + 1
            ref = int8scan.int8_gather_scan_reference(qq, qs, *dev, sel)
            assert torch.equal(got, ref), (b, lc, d)

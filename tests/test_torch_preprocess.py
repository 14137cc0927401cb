"""Port's `models/preprocess.py::resize_on_device` against the JAX package's.

The same numpy-seeded batches, uint8 and float in [0, 1), go through
`jax.image.resize(..., "bicubic")` (the JAX function, on the CPU) and the
port's antialiased `F.interpolate` on CPU tensors, at downsampling
(480×640→224), upsampling (100×90→224), identity (224→224) and a
non-square extreme (37×1000→64).  Bar: atol 2e-5 (f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_retrieval_tpu.models.preprocess import resize_on_device as jax_resize
from clip_retrieval_tpu_torch.models.preprocess import resize_on_device

ATOL = 2e-5
GEOMETRIES = [(480, 640, 224), (100, 90, 224), (224, 224, 224), (37, 1000, 64)]


def _batch(h: int, w: int, dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    return rng.random((2, h, w, 3), dtype=np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("h,w,size", GEOMETRIES, ids=[f"{h}x{w}to{s}" for h, w, s in GEOMETRIES])
def test_resize_on_device_matches_jax(h, w, size, dtype):
    x = _batch(h, w, dtype)
    want = np.asarray(jax_resize(jnp.asarray(x), size))
    got = resize_on_device(torch.from_numpy(x), size)
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_resize_on_device_takes_numpy_on_the_given_device_and_does_not_clamp():
    x = _batch(100, 90, "float32", seed=1) * 4.0 - 2.0  # bicubic overshoots past the input's range
    got = resize_on_device(x, 224, device="cpu")
    want = np.asarray(jax_resize(jnp.asarray(x), 224))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * ATOL)
    assert got.min().item() < -2.0 and got.max().item() > 2.0

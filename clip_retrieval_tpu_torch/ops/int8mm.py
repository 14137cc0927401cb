"""Int8 similarity search ops: symmetric per-row quantization and exact int8
scoring.

Counterpart of `clip_retrieval_tpu/ops/int8mm.py`.  `quantize_rows` is the
JAX package's numpy function, copied; `quantize_rows_device` does the JAX
device function's ops in the same order on a torch tensor (max |x| / 127
floored at 1e-10, round half to even, clip to ±127, int8).

PyTorch has no int8 x int8 → int32 matrix product on CUDA, so
`int8_matmul_nt` computes it in f32 there.  That is exact while every
partial sum stays below 2^24 in magnitude: with |values| ≤ 127 (what the
quantizers produce), 127² · d < 2^24 holds for d ≤ 1040, which covers every
CLIP width.  It raises above that bound and when TF32 would round the
product.  On the CPU it takes torch's int32 product.
"""

from __future__ import annotations

import numpy as np
import torch

EXACT_F32_MAX_D = 1040  # 127² · 1040 < 2^24
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_rows(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: returns (q (n,d) int8, scale (n,) f32)."""
    x = np.asarray(x, np.float32)
    scale = np.abs(x).max(axis=1) / 127.0
    scale = np.maximum(scale, 1e-10)
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_rows_device(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows` on a tensor, on its device: (q (n,d) int8, scale (n,) f32).

    The scale is max|x| times the f32 reciprocal of 127, not max|x| / 127:
    XLA folds the JAX function's division by the constant into that
    multiply, and the scales must match the JAX package's bit for bit (the
    host `quantize_rows` divides, and differs from both by an ulp at times)."""
    scale = torch.clamp(x.abs().amax(dim=1) * _INV_127, min=1e-10)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale.float()


def _tf32_allowed() -> bool:
    return torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"


def int8_matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, d) int8 · b (N, d)ᵀ int8, summed exactly, as f32 (M, N).

    The plain int8 product of the port (no kernel): int32 on the CPU, f32 on
    CUDA within the exactness bound of the module docstring."""
    if a.device.type == "cpu":
        return torch.matmul(a.int(), b.int().T).float()
    d = a.shape[1]
    if d > EXACT_F32_MAX_D:
        raise ValueError(f"int8 product in f32 is exact only for d <= {EXACT_F32_MAX_D}, got d={d}")
    if _tf32_allowed():
        raise RuntimeError(
            "TF32 is allowed for f32 matmuls (torch.backends.cuda.matmul.allow_tf32 or "
            "float32_matmul_precision != 'highest'); the f32 int8 product would not be exact"
        )
    return torch.matmul(a.float(), b.float().T)


def int8_topk(q: torch.Tensor, db: torch.Tensor, db_scale: torch.Tensor, k: int):
    """Exact int8 top-k: quantize the (B, d) f32 queries, exact int8 product
    with the (N, d) int8 db, rescale by both scales, top-k.  Returns
    (vals (B, k) f32, idx (B, k) int64)."""
    qq, q_scale = quantize_rows_device(q)
    scores = int8_matmul_nt(qq, db) * q_scale[:, None] * db_scale[None, :]
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx

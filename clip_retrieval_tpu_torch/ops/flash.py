"""Fused attention: kernels K1 (packed layout) and K2 ((B, H, S, dh) layout).

Counterparts of `clip_retrieval_tpu/ops/flash.py::flash_attention_packed`
(K1, on the packed (B, S, W) projection layout the towers use) and
`::flash_attention` (K2, on (B, H, S, dh), Sk may differ from Sq; the
`attention.sdpa` entry).  Both are entries of one hand-written Hopper kernel,
`csrc/flash_packed.cu` (built with nvcc at first use): on CUDA tensors a
wrapper launches it or raises; on CPU tensors it runs its plain version, the
same math in plain PyTorch.  Which one runs depends only on where the tensors
live (`cuda_build.route`).  Each wrapper counts its own launches
(`cuda_build.Kernel.launch`), in all and by the device route that
`kernel_route` chooses.
"""

from __future__ import annotations

import torch

from . import cuda_build

LIBRARY = "flash_packed"
_PACKED = cuda_build.Kernel(LIBRARY, "crt_flash_packed")
_BHSD = cuda_build.Kernel(LIBRARY, "crt_flash_bhsd")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
ROUTES = ("wgmma", "mma_sync", "f32")  # the kernel's device routes (csrc/flash_packed.cu)


def kernel_route(dtype: torch.dtype, dh: int, ptrs: list[int]) -> str:
    """The device route of one call: f32 takes the f32 kernel; bf16 with dh %
    8 == 0 and every pointer 16-byte aligned (16-byte loads) takes the wgmma
    route at any dh ≤ 128; other bf16 calls the mma.sync route.  The kernel
    takes the wgmma route exactly when it is handed `vec` = 1."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if dh % 8 == 0 and all(p % 16 == 0 for p in ptrs) else "mma_sync"


def flash_attention_packed_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *, causal: bool = False
) -> torch.Tensor:
    """Plain packed attention, the counterpart of the JAX kernel's
    `_attend_2d` run over every head: f32 logits scaled by dh^-½, an
    optional causal mask (-1e30), f32 softmax, probabilities cast to v's
    dtype, P·V accumulated in f32, output in q's dtype and layout."""
    b, s, w = q.shape
    sk = k.shape[1]
    dh = w // heads

    def split(x, n):  # (B, n, W) -> (B, H, n, dh), f32
        return x.reshape(b, n, heads, dh).transpose(1, 2).float()

    logits = torch.matmul(split(q, s), split(k, sk).transpose(-1, -2)) * (dh ** -0.5)
    if causal:
        keep = torch.ones(s, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.matmul(probs, split(v, sk))
    return out.transpose(1, 2).reshape(b, s, w).to(q.dtype)


def flash_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *, causal: bool = False
) -> torch.Tensor:
    """softmax(q·kᵀ·dh^-½ [causal]) · v per head on packed (B, S, W) tensors,
    W = heads·dh, each head a column slice of width dh.  Returns (B, S, W)
    in q's dtype.

    CUDA tensors: bf16 or f32, contiguous, equal shapes, dh ≤ 128; anything
    else raises.  CPU tensors: the plain reference.  Either raises when an
    input requires grad under grad mode: the kernel has no backward."""
    if cuda_build.route("flash_attention_packed", q, k, v) == "cpu":
        return flash_attention_packed_reference(q, k, v, heads, causal=causal)
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be equal (B, S, W) shapes, got {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must all be bfloat16 or float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    b, s, w = q.shape
    if heads <= 0 or w % heads:
        raise ValueError(f"width {w} is not a multiple of heads={heads}")
    dh = w // heads
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM} is not supported by the kernel")
    if b > 65535 or heads > 65535:
        raise ValueError(f"batch {b} or heads {heads} exceeds the kernel grid limit 65535")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    path = kernel_route(q.dtype, dh, ptrs)
    _PACKED.launch(flash_attention_packed, q.device, lambda: f"B={b} S={s} heads={heads} dh={dh}",
                   *ptrs, b, s, heads, dh, int(causal), _DTYPE_CODE[q.dtype], int(path == "wgmma"), route=path)
    return out


flash_attention_packed.launches = 0  # kernel launches, counted only where the kernel launches
flash_attention_packed.launches_by_route = dict.fromkeys(ROUTES, 0)  # the same, by `kernel_route`


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Plain (B, H, S, dh) attention, the counterpart of the JAX kernel's
    `_attn_kernel`: `attention.sdpa_reference` with f32 logits (dh^-½ scale,
    causal mask -1e30 where key j > query row i, f32 softmax, probabilities
    cast to v's dtype, P·V accumulated in f32, output in v's dtype)."""
    from .attention import sdpa_reference  # attention imports this module

    return sdpa_reference(q, k, v, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ·dh^-½ [causal]) · v on q (B, H, Sq, dh), k and v
    (B, H, Sk, dh).  Returns (B, H, Sq, dh) in q's dtype.

    CUDA tensors: bf16 or f32, contiguous, dh ≤ 128; anything else raises.
    CPU tensors: the plain reference.  Either raises when an input requires
    grad under grad mode: the kernel has no backward."""
    if cuda_build.route("flash_attention", q, k, v) == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q must be (B, H, Sq, dh) and k, v (B, H, Sk, dh), got {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must all be bfloat16 or float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM} is not supported by the kernel")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceeds the kernel grid limit 65535")
    if sk == 0:
        raise ValueError("attention over zero keys")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    path = kernel_route(q.dtype, dh, ptrs)
    _BHSD.launch(flash_attention, q.device, lambda: f"B={b} H={h} Sq={sq} Sk={sk} dh={dh}",
                 *ptrs, b, h, sq, sk, dh, int(causal), _DTYPE_CODE[q.dtype], int(path == "wgmma"), route=path)
    return out


flash_attention.launches = 0  # kernel launches, counted only where the kernel launches
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)  # the same, by `kernel_route`

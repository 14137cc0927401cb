"""Fused attention: kernels K1 (packed layout) and K2 ((B, H, S, dh) layout).

Counterparts of `clip_retrieval_tpu/ops/flash.py::flash_attention_packed`
(K1, on the packed (B, S, W) projection layout the towers use) and
`::flash_attention` (K2, on (B, H, S, dh), Sk may differ from Sq; the
`attention.sdpa` entry).  Both are entries of one hand-written Hopper kernel,
`csrc/flash_packed.cu` (built with nvcc at first use): on CUDA tensors a
wrapper launches it or raises; on CPU tensors it runs its plain version, the
same math in plain PyTorch.  Which one runs depends only on where the tensors
live.  Each wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

_LAUNCH_LOCK = threading.Lock()
_LIB_NAME = "flash_packed"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


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


@functools.cache
def _lib() -> ctypes.CDLL:
    from .cuda_build import load_library

    lib = load_library(_LIB_NAME, ["flash_packed.cu"])
    # every pointer and the stream as c_void_p: a default int would cut them to 32 bits
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crt_flash_packed.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.crt_flash_packed.restype = ci
    lib.crt_flash_bhsd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.crt_flash_bhsd.restype = ci
    lib.crt_cuda_error_string.argtypes = [ci]
    lib.crt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile (or find) and load the kernel's library now."""
    _lib()


def flash_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *, causal: bool = False
) -> torch.Tensor:
    """softmax(q·kᵀ·dh^-½ [causal]) · v per head on packed (B, S, W) tensors,
    W = heads·dh, each head a column slice of width dh.  Returns (B, S, W)
    in q's dtype.

    CUDA tensors: bf16 or f32, contiguous, equal shapes, dh ≤ 128; anything
    else raises.  CPU tensors: the plain reference."""
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, heads, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed runs on cuda or cpu tensors, got {q.device}")
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
    vec = int(q.dtype == torch.bfloat16 and dh % 8 == 0 and all(p % 16 == 0 for p in ptrs))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.crt_flash_packed(
            *ptrs, b, s, heads, dh, int(causal), _DTYPE_CODE[q.dtype], vec, stream
        )
    if rc != 0:
        msg = lib.crt_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_packed kernel launch failed ({rc}: {msg}) at B={b} S={s} heads={heads} dh={dh}")
    with _LAUNCH_LOCK:  # wrappers run on several server threads at once
        flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0  # kernel launches, counted only where the kernel launches


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
    CPU tensors: the plain reference."""
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
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
    vec = int(q.dtype == torch.bfloat16 and dh % 8 == 0 and all(p % 16 == 0 for p in ptrs))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.crt_flash_bhsd(*ptrs, b, h, sq, sk, dh, int(causal), _DTYPE_CODE[q.dtype], vec, stream)
    if rc != 0:
        msg = lib.crt_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed ({rc}: {msg}) at B={b} H={h} Sq={sq} Sk={sk} dh={dh}")
    with _LAUNCH_LOCK:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches, counted only where the kernel launches

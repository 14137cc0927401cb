"""A transformer block's elementwise work as two hand-written kernels: the
epilogue after each dense, and a one-pass LayerNorm.

Both are entries of `csrc/block_fused.cu` (built with nvcc at first use).
They replace no Pallas kernel of the JAX package: on the TPU, XLA fuses the
bias add, the activation, the residual add and the casts into the matmul's
consumer, and LayerNorm into one pass, while eager PyTorch runs each op as
its own pass over device memory.  The work is bound by bytes, so each kernel
reads and writes every element once and keeps the intermediates in
registers, rounding where the eager chain rounds (the source's note).

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs its plain version, which is the eager chain itself (`cuda_build.route`).
Each wrapper counts its launches (`cuda_build.Kernel.launch`); `record_eager`
counts the dense and LayerNorm calls of `models/clip.py` that took the eager
chain because an input requires grad (the kernels have no backward).
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from . import cuda_build

_LOCK = threading.Lock()
LIBRARY = "block_fused"
_EPILOGUE = cuda_build.Kernel(LIBRARY, "crt_dense_epilogue")
_LAYERNORM = cuda_build.Kernel(LIBRARY, "crt_layernorm")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODE = {None: 0, "quick_gelu": 1, "gelu": 2, "gelu_tanh": 3}
MAX_LN_WIDTH = 2048  # the row in registers: 8 f32 a lane per 256 of width, 64 at most


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The towers' activations in x's dtype, op by op as eager PyTorch runs them."""
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "gelu":
        return F.gelu(x, approximate="none")
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {kind}")


def dense_epilogue_reference(
    acc: torch.Tensor, bias: torch.Tensor | None, act: str | None, residual: torch.Tensor | None, dtype: torch.dtype
) -> torch.Tensor:
    """The eager chain after a dense: the f32 accumulator plus the f32 bias,
    cast to `dtype`, the activation, then residual + the result."""
    y = acc if bias is None else acc + bias.float()
    y = y.to(dtype)
    if act is not None:
        y = activation(y, act)
    return y if residual is None else residual + y


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The eager LayerNorm: x upcast to f32, normalised over its last axis
    with f32 scale and bias, cast back to x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def record_eager() -> None:
    """Count one dense or LayerNorm call that took the eager chain."""
    with _LOCK:
        record_eager.calls += 1


record_eager.calls = 0


def counts() -> tuple[int, int]:
    """(kernel launches of both wrappers, eager-chain calls) so far."""
    return dense_epilogue.launches + layernorm.launches, record_eager.calls


def dense_epilogue(
    acc: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    act: str | None = None,
    residual: torch.Tensor | None = None,
    dtype: torch.dtype,
) -> torch.Tensor:
    """`dense_epilogue_reference` in one pass: the f32 accumulator (..., N)
    plus the f32 bias (N), the activation, the residual (acc's shape, in
    `dtype`), written in `dtype`.

    CUDA tensors: acc f32 and contiguous, bias f32 1-D of length N, residual
    contiguous, dtype bf16 or f32; anything else raises.  With nothing to
    add and dtype f32 the accumulator is the result, and nothing launches.
    CPU tensors: the plain version."""
    kind = cuda_build.route("dense_epilogue", acc, bias, residual)
    if act not in ACT_CODE:
        raise ValueError(f"unknown act {act}")
    if kind == "cpu":
        return dense_epilogue_reference(acc, bias, act, residual, dtype)
    if acc.dtype != torch.float32 or not acc.is_contiguous() or acc.dim() == 0:
        raise ValueError(f"acc must be a contiguous float32 tensor of rank ≥ 1, got {acc.dtype} {tuple(acc.shape)}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dense_epilogue writes bfloat16 or float32, not {dtype}")
    n = acc.shape[-1]
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({n},) tensor, got {bias.dtype} {tuple(bias.shape)}")
    if residual is not None and (
        residual.dtype != dtype or residual.shape != acc.shape or not residual.is_contiguous()
    ):
        raise ValueError(f"residual must be a contiguous {dtype} tensor of shape {tuple(acc.shape)}, "
                         f"got {residual.dtype} {tuple(residual.shape)} contiguous={residual.is_contiguous()}")
    if bias is None and act is None and residual is None and dtype == torch.float32:
        return acc
    out = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _EPILOGUE.launch(dense_epilogue, acc.device, lambda: f"acc {tuple(acc.shape)}", acc.data_ptr(), ptr(bias),
                     ptr(residual), out.data_ptr(), acc.numel() // n, n, ACT_CODE[act], _DTYPE_CODE[dtype])
    return out


dense_epilogue.launches = 0  # kernel launches, counted only where the kernel launches


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """`layernorm_reference` in one pass over x (..., W): statistics and the
    affine step in f32, written in x's dtype.

    CUDA tensors: x bf16 or f32 and contiguous, W ≤ 2048, scale and bias f32
    contiguous (W,); anything else raises.  CPU tensors: the plain version."""
    if cuda_build.route("layernorm", x, scale, bias) == "cpu":
        return layernorm_reference(x, scale, bias, eps)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"layernorm takes bfloat16 or float32, not {x.dtype}")
    if not x.is_contiguous() or x.dim() == 0:
        raise ValueError(f"x must be contiguous and of rank ≥ 1, got {tuple(x.shape)} strides {x.stride()}")
    w = x.shape[-1]
    if w > MAX_LN_WIDTH:
        raise ValueError(f"width {w} > {MAX_LN_WIDTH} is not supported by the kernel")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (w,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({w},) tensor, got {p.dtype} {tuple(p.shape)}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _LAYERNORM.launch(layernorm, x.device, lambda: f"x {tuple(x.shape)}", x.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), x.numel() // w, w, float(eps), _DTYPE_CODE[x.dtype])
    return out


layernorm.launches = 0  # kernel launches, counted only where the kernel launches

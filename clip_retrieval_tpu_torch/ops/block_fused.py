"""A transformer block's elementwise work as hand-written kernels: the
epilogue after each dense, a one-pass LayerNorm, and for a rotary SwiGLU
tower (EVA02) the q/k products' rotary epilogue and the SwiGLU gate with its
LayerNorm; and a dense's product with its epilogue as one GEMM kernel.

The elementwise passes are entries of `csrc/block_fused.cu`, the GEMM
(`dense_gemm`) the entry of `csrc/dense_gemm.cu` (each built with nvcc at
first use).
They replace no Pallas kernel of the JAX package: on the TPU, XLA fuses the
bias add, the activation, the residual add and the casts into the matmul's
consumer, and LayerNorm into one pass, while eager PyTorch runs each op as
its own pass over device memory.  The work is bound by bytes, so each kernel
reads and writes every element once and keeps the intermediates in
registers, rounding where the eager chain rounds (the source's note).

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs its plain version, which is the eager chain itself (`cuda_build.route`).
Each wrapper counts its launches (`cuda_build.Kernel.launch`); `record_eager`
counts the dense, LayerNorm, rotary and gate calls of `models/clip.py` that
took the eager chain because an input requires grad (the kernels have no
backward).

A dense of `models/clip.py` on CUDA takes one of two routes, chosen by
`dense_route` from what the call shows: "gemm", `dense_gemm`'s one kernel
that applies the epilogue to the product in its registers, or "split", the
f32 product by cuBLAS and `dense_epilogue` over it.  Both compute each
element of the epilogue with the same device function
(`csrc/dense_epilogue.cuh`); the products differ only in the order of the
f32 sums.
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
_ROPE = cuda_build.Kernel(LIBRARY, "crt_rope")
_GLU = cuda_build.Kernel(LIBRARY, "crt_glu_layernorm")
GEMM_LIBRARY = "dense_gemm"
_GEMM = cuda_build.Kernel(GEMM_LIBRARY, "crt_dense_gemm")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODE = {None: 0, "quick_gelu": 1, "gelu": 2, "gelu_tanh": 3}
MAX_LN_WIDTH = 2048  # the row in registers: 8 f32 a lane per 256 of width, 64 at most
MAX_GLU_WIDTH = 4096  # the gate's padded hidden in a block's registers, 32 f32 a thread at most
GEMM_TILE = 192  # `dense_gemm`'s output tiles are 192 × 192, one persistent block an SM walking them
# the deepest K that `dense_gemm` takes when its tiles fill fewer than the card's SMs: each tile's K then runs
# on one SM while cuBLAS, on the split route, splits K over the idle ones.  tools/ab_dense.py on an H100
# (PERF.md), two runs at 1-2048 rows: the kernel beat the split route at K 768 and 1152 at every row count,
# and at K 3072 at all but one (~0.042 ms against 0.040-0.057); at K 4304 split won at 12 of 14 (the kernel
# 0.054-0.061 ms against 0.035-0.053)
GEMM_DEEP_K = 3072
# of each 192-column tile of `dense_gemm`, the 64-column groups whose epilogue its consumer warps run
# themselves, by activation and then by whether a residual is added; the finisher warps run the rest under
# the next tile's products.  The costlier an element's epilogue, the more the consumers take, so that the
# finishers keep up (tools/ab_dense.py --modes, PERF.md)
GEMM_DIRECT = {None: (0, 1), "gelu": (1, 1), "gelu_tanh": (2, 2), "quick_gelu": (3, 3)}



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


def rope_reference(
    acc: torch.Tensor, bias: torch.Tensor | None, table: torch.Tensor, prefix: int, dtype: torch.dtype
) -> torch.Tensor:
    """The plain rotary epilogue: the f32 accumulator (B, S, W) plus the f32
    bias; in every head of dh = 2·table.shape[-1] columns of the rows from
    `prefix` on, pair (2i, 2i+1) = (a, b) → (a·cos − b·sin, b·cos + a·sin)
    with cos = table[0, s − prefix, i] and sin = table[1, s − prefix, i];
    the rest as it is; cast to `dtype` once."""
    y = acc if bias is None else acc + bias.float()
    b, s, w = y.shape
    half = table.shape[-1]
    pairs = y[:, prefix:].reshape(b, s - prefix, w // (2 * half), half, 2)
    a, o = pairs[..., 0], pairs[..., 1]
    cos, sin = table[0, :, None, :], table[1, :, None, :]
    turned = torch.stack((a * cos - o * sin, o * cos + a * sin), dim=-1).reshape(b, s - prefix, w)
    return torch.cat((y[:, :prefix], turned), dim=1).to(dtype)


def glu_layernorm_reference(
    acc: torch.Tensor, bias: torch.Tensor | None, scale: torch.Tensor, ln_bias: torch.Tensor, eps: float,
    dtype: torch.dtype,
) -> torch.Tensor:
    """The plain SwiGLU middle: acc (..., 2·hp) f32 plus the f32 bias, g the
    first h = len(scale) columns and x the h from hp on; silu(g)·x
    normalised over its h columns with f32 scale and bias, zeros in columns
    [h, hp), cast to `dtype` once."""
    y = acc if bias is None else acc + bias.float()
    hp, h = y.shape[-1] // 2, scale.shape[0]
    hidden = F.silu(y[..., :h]) * y[..., hp : hp + h]
    out = F.layer_norm(hidden, (h,), scale.float(), ln_bias.float(), eps)
    return F.pad(out, (0, hp - h)).to(dtype)


def record_eager() -> None:
    """Count one dense, LayerNorm, rotary or gate call that took the eager chain."""
    with _LOCK:
        record_eager.calls += 1


record_eager.calls = 0


def counts() -> tuple[int, int]:
    """(kernel launches of every wrapper, eager-chain calls) so far."""
    launches = (dense_epilogue.launches + layernorm.launches + rope_epilogue.launches + glu_layernorm.launches
                + dense_gemm.launches)
    return launches, record_eager.calls


def _sm_count(device: torch.device) -> int | None:
    """The card's SM count, or None off CUDA."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).multi_processor_count


def gemm_refusal(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, residual: torch.Tensor | None,
                 dtype: torch.dtype = torch.bfloat16, act: str | None = None) -> Exception | None:
    """What `dense_gemm` raises for these tensors on the card, or None where
    it takes them (`dense_gemm` states what it takes)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        return ValueError(f"x (M, K) and w (K, N) expected, got {tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if k == 0:
        return ValueError("dense_gemm needs a depth K > 0")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return TypeError(f"dense_gemm multiplies bfloat16 operands, got {x.dtype} and {w.dtype}")
    if (x.stride(1) != 1 and k > 1) or x.stride(0) % 8 or x.stride(0) < k or x.data_ptr() % 16:
        return ValueError(f"x must have unit column stride, a row stride that is a multiple of 8 and 16-byte "
                          f"aligned data, got strides {x.stride()}")
    if not w.is_contiguous() or n % 8 or w.data_ptr() % 16:
        return ValueError(f"w must be contiguous and 16-byte aligned with N a multiple of 8, got {tuple(w.shape)}")
    if dtype not in (torch.bfloat16, torch.float32):
        return TypeError(f"dense_gemm writes bfloat16 or float32, not {dtype}")
    if dtype == torch.float32 and (bias is not None or act is not None or residual is not None):
        return ValueError("dense_gemm writes the f32 product alone: no bias, act or residual")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,) or not bias.is_contiguous()):
        return ValueError(f"bias must be a contiguous float32 ({n},) tensor, got {bias.dtype} {tuple(bias.shape)}")
    if residual is not None and (residual.dtype != torch.bfloat16 or residual.shape != (m, n)
                                 or not residual.is_contiguous() or residual.data_ptr() % 16):
        return ValueError(f"residual must be a contiguous, 16-byte aligned bfloat16 tensor of shape {(m, n)}, "
                          f"got {residual.dtype} {tuple(residual.shape)} contiguous={residual.is_contiguous()}")
    return None


def dense_route(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                residual: torch.Tensor | None = None, *, reduce: bool = False, grad: bool = False) -> str:
    """The route of residual + act(x @ w + bias) in x's dtype, x (M, K) and
    w (K, N), from the tensors themselves: "gemm" (`dense_gemm`) for a CUDA
    bf16 call that `dense_gemm` takes (`gemm_refusal`), with no
    tensor-parallel `reduce` of the f32 product and nothing for autograd to
    record (`grad`), unless its tiles fill fewer than the card's SMs and K
    is deeper than `GEMM_DEEP_K`; "split" (the f32 product, then
    `dense_epilogue` or its eager chain) for every other call."""
    sms = _sm_count(x.device)
    if sms is None or reduce or grad or gemm_refusal(x, w, bias, residual):
        return "split"
    (m, k), n = x.shape, w.shape[1]
    tiles = -(-m // GEMM_TILE) * -(-n // GEMM_TILE)
    return "split" if tiles < sms and k > GEMM_DEEP_K else "gemm"


def dense_gemm_reference(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, act: str | None, residual: torch.Tensor | None,
    dtype: torch.dtype,
) -> torch.Tensor:
    """The plain dense: x @ w in f32, then `dense_epilogue_reference` in
    `dtype`; with dtype f32 and nothing to add, the f32 product itself."""
    acc = torch.matmul(x.float(), w.float())
    return dense_epilogue_reference(acc, bias, act, residual, dtype)


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


def rope_epilogue(
    acc: torch.Tensor, bias: torch.Tensor | None, table: torch.Tensor, *, prefix: int, dtype: torch.dtype
) -> torch.Tensor:
    """`rope_reference` in one pass: the f32 accumulator (B, S, W) of a q or
    k product plus the f32 bias (W), each head's pairs of the rows from
    `prefix` on turned by the angles of `table` (2, S − prefix, dh/2), f32
    cos then sin, written in `dtype`.

    CUDA tensors: acc f32 contiguous, bias f32 (W,) or None, table f32
    contiguous, W a multiple of dh, dtype bf16 or f32; anything else raises.
    CPU tensors: the plain version."""
    if cuda_build.route("rope_epilogue", acc, bias, table) == "cpu":
        return rope_reference(acc, bias, table, prefix, dtype)
    if acc.dtype != torch.float32 or not acc.is_contiguous() or acc.dim() != 3:
        raise ValueError(f"acc must be a contiguous float32 (B, S, W) tensor, got {acc.dtype} {tuple(acc.shape)}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"rope_epilogue writes bfloat16 or float32, not {dtype}")
    b, s, w = acc.shape
    if table.dtype != torch.float32 or not table.is_contiguous() or table.dim() != 3 or table.shape[:2] != (
            2, s - prefix) or not 0 <= prefix < s:
        raise ValueError(f"table must be a contiguous float32 (2, {s - prefix}, dh/2) tensor for S={s} and "
                         f"prefix={prefix}, got {table.dtype} {tuple(table.shape)}")
    dh = 2 * table.shape[2]
    if w % dh:
        raise ValueError(f"width {w} is not a multiple of the head dim {dh}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (w,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({w},) tensor, got {bias.dtype} {tuple(bias.shape)}")
    out = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _ROPE.launch(rope_epilogue, acc.device, lambda: f"acc {tuple(acc.shape)} dh={dh}", acc.data_ptr(), ptr(bias),
                 table.data_ptr(), out.data_ptr(), b * s, s, prefix, w, dh, _DTYPE_CODE[dtype])
    return out


rope_epilogue.launches = 0  # kernel launches, counted only where the kernel launches


def glu_layernorm(
    acc: torch.Tensor, bias: torch.Tensor | None, scale: torch.Tensor, ln_bias: torch.Tensor, eps: float, *,
    dtype: torch.dtype,
) -> torch.Tensor:
    """`glu_layernorm_reference` in one pass: from the gate product's f32
    accumulator (..., 2·hp) and bias (2·hp), silu(g)·x over the h =
    len(scale) hidden columns, its LayerNorm, written (..., hp) in `dtype`
    with zeros in the pad columns.

    CUDA tensors: acc f32 contiguous, h ≤ hp ≤ 4096, bias f32 (2·hp,) or
    None, scale and ln_bias f32 contiguous (h,), dtype bf16 or f32; anything
    else raises.  CPU tensors: the plain version."""
    if cuda_build.route("glu_layernorm", acc, bias, scale, ln_bias) == "cpu":
        return glu_layernorm_reference(acc, bias, scale, ln_bias, eps, dtype)
    if acc.dtype != torch.float32 or not acc.is_contiguous() or acc.dim() == 0 or acc.shape[-1] % 2:
        raise ValueError(f"acc must be a contiguous float32 (..., 2·hp) tensor, got {acc.dtype} {tuple(acc.shape)}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"glu_layernorm writes bfloat16 or float32, not {dtype}")
    hp, h = acc.shape[-1] // 2, scale.shape[0]
    if not 0 < h <= hp <= MAX_GLU_WIDTH:
        raise ValueError(f"hidden {h} padded to {hp}: the kernel takes 0 < h ≤ hp ≤ {MAX_GLU_WIDTH}")
    for name, p in (("scale", scale), ("ln_bias", ln_bias)):
        if p.dtype != torch.float32 or p.shape != (h,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({h},) tensor, got {p.dtype} {tuple(p.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (2 * hp,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({2 * hp},) tensor, got {bias.dtype} {tuple(bias.shape)}")
    out = torch.empty((*acc.shape[:-1], hp), dtype=dtype, device=acc.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _GLU.launch(glu_layernorm, acc.device, lambda: f"acc {tuple(acc.shape)} h={h}", acc.data_ptr(), ptr(bias),
                scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), out.numel() // hp, h, hp, float(eps),
                _DTYPE_CODE[dtype])
    return out


glu_layernorm.launches = 0  # kernel launches, counted only where the kernel launches



def dense_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    act: str | None = None,
    residual: torch.Tensor | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """`dense_gemm_reference` in one kernel: residual + act(x @ w + bias) in
    bf16, the product accumulated in f32 in registers and the epilogue
    (`dense_epilogue`'s arithmetic) applied there, so that no f32 product is
    written.  With dtype f32: the f32 product alone.

    CUDA tensors: x (M, K) bf16 with unit column stride and a row stride
    that is a multiple of 8, 16-byte aligned; w (K, N) bf16 contiguous, N a
    multiple of 8, 16-byte aligned; bias f32 (N,) or None; residual bf16 (M,
    N) contiguous and 16-byte aligned, or None; with dtype f32 no bias, act
    or residual; anything else raises.  CPU tensors: the plain version."""
    kind = cuda_build.route("dense_gemm", x, w, bias, residual)
    if act not in ACT_CODE:
        raise ValueError(f"unknown act {act}")
    if kind == "cpu":
        return dense_gemm_reference(x, w, bias, act, residual, dtype)
    refusal = gemm_refusal(x, w, bias, residual, dtype, act)
    if refusal is not None:
        raise refusal
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _GEMM.launch(dense_gemm, x.device, lambda: f"x {tuple(x.shape)} w {tuple(w.shape)}", x.data_ptr(),
                 w.data_ptr(), ptr(bias), ptr(residual), out.data_ptr(), m, n, k, x.stride(0), ACT_CODE[act],
                 int(dtype == torch.float32), GEMM_DIRECT[act][residual is not None])
    return out


dense_gemm.launches = 0  # kernel launches, counted only where the kernel launches

"""Fused gather-scan of the IVF-int8 probed union: kernel K3.

Counterpart of `clip_retrieval_tpu/ops/int8scan.py::int8_gather_scan`.  For
each selected chunk `chunk_sel[i]` of the chunked CSR image, the int8
product of the quantized queries with the chunk's rows, dequantized as
`(f32(acc) · q_scale[b]) · scales[chunk, j]` and set to −inf on padding rows
(`pos < 0`), lands in columns [i·Lc, (i+1)·Lc) of a (B, U·Lc) f32 output.

On CUDA tensors `int8_gather_scan` launches the hand-written Hopper kernel
in `csrc/int8_scan.cu` (built with nvcc at first use) or raises; on CPU
tensors it runs `int8_gather_scan_reference`, the same result in plain
PyTorch (index_select, exact int8 product, the same epilogue).  The two are
bit-identical.  Which one runs depends only on where the tensors live
(`cuda_build.route`).
There is no segmenting of long selections: the kernel's grid has no
per-call limit that needs it.
"""

from __future__ import annotations

import torch

from . import cuda_build

from .int8mm import int8_matmul_nt

LIBRARY = "int8_scan"
_SCAN = cuda_build.Kernel(LIBRARY, "crt_int8_gather_scan")
MAX_D = 2048  # the kernel stages all of d of its query rows in shared memory


def int8_gather_scan_reference(
    qq: torch.Tensor,
    q_scale: torch.Tensor,
    rows: torch.Tensor,
    scales: torch.Tensor,
    pos: torch.Tensor,
    chunk_sel: torch.Tensor,
) -> torch.Tensor:
    """Plain version: gather the selected chunks, exact int8 product
    (`int8_matmul_nt`), dequantize in the kernel's order, mask padding."""
    u = chunk_sel.shape[0]
    _, lc, d = rows.shape
    sel = chunk_sel.long()
    acc = int8_matmul_nt(qq, rows.index_select(0, sel).reshape(u * lc, d))
    scores = acc * q_scale.float()[:, None] * scales.index_select(0, sel).reshape(1, u * lc)
    valid = pos.index_select(0, sel).reshape(1, u * lc) >= 0
    return torch.where(valid, scores, float("-inf"))


def _check(qq, q_scale, rows, scales, pos, chunk_sel) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if qq.dim() != 2 or rows.dim() != 3 or qq.shape[1] != rows.shape[2]:
        raise ValueError(f"qq must be (B, d) and rows (nchunks, Lc, d), got {tuple(qq.shape)}, {tuple(rows.shape)}")
    b, d = qq.shape
    nchunks, lc, _ = rows.shape
    if q_scale.shape != (b,):
        raise ValueError(f"q_scale must be ({b},), got {tuple(q_scale.shape)}")
    if scales.shape != (nchunks, lc) or pos.shape != (nchunks, lc):
        raise ValueError(f"scales and pos must be ({nchunks}, {lc}), got {tuple(scales.shape)}, {tuple(pos.shape)}")
    if chunk_sel.dim() != 1:
        raise ValueError(f"chunk_sel must be (U,), got {tuple(chunk_sel.shape)}")
    want = {"qq": (qq, torch.int8), "q_scale": (q_scale, torch.float32), "rows": (rows, torch.int8),
            "scales": (scales, torch.float32), "pos": (pos, torch.int32), "chunk_sel": (chunk_sel, torch.int32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d > MAX_D:
        raise ValueError(f"d={d} > {MAX_D} is not supported by the kernel")
    if b > 65535 * 64:
        raise ValueError(f"batch {b} exceeds the kernel grid limit")


def int8_gather_scan(
    qq: torch.Tensor,  # (B, d) int8 — quantize_rows_device output
    q_scale: torch.Tensor,  # (B,) f32
    rows: torch.Tensor,  # (nchunks, Lc, d) int8 — the chunked CSR image
    scales: torch.Tensor,  # (nchunks, Lc) f32 (0 ⇒ padding row)
    pos: torch.Tensor,  # (nchunks, Lc) int32 (−1 ⇒ padding row)
    chunk_sel: torch.Tensor,  # (U,) int32 — selected chunks, each in [0, nchunks)
) -> torch.Tensor:
    """Masked dequantized scores (B, U·Lc) f32 of the selected chunks.

    CUDA tensors: the dtypes above, contiguous, d ≤ 2048; anything else
    raises.  A selection outside [0, nchunks) gives NaN scores for that
    chunk on CUDA (the kernel reads only inside the image) and raises on the
    CPU.  CPU tensors: the plain reference."""
    tensors = (qq, q_scale, rows, scales, pos, chunk_sel)
    if cuda_build.route("int8_gather_scan", *tensors) == "cpu":
        return int8_gather_scan_reference(*tensors)
    _check(*tensors)
    b, d = qq.shape
    nchunks, lc, _ = rows.shape
    u = chunk_sel.shape[0]
    out = torch.empty((b, u * lc), dtype=torch.float32, device=qq.device)
    if out.numel() == 0:
        return out
    vec = int(d % 16 == 0 and qq.data_ptr() % 16 == 0 and rows.data_ptr() % 16 == 0)
    _SCAN.launch(int8_gather_scan, qq.device, lambda: f"B={b} d={d} Lc={lc} U={u}",
                 *(t.data_ptr() for t in tensors), out.data_ptr(), b, d, lc, nchunks, u, vec)
    return out


int8_gather_scan.launches = 0  # kernel launches, counted only where the kernel launches

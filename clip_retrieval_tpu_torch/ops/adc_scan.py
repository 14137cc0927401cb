"""IVF-PQ ADC scan of a chunk worklist: kernel K4.

Counterpart of `clip_retrieval_tpu/ops/adc_scan.py::adc_scan`.  Chunk i of the
worklist is code rows [blocks[i]·C, (blocks[i]+1)·C) of the list-aligned code
array, scored for query owner[i] as Σ_m lut[owner[i], m, code_m] + coarse[i],
with −inf for rows r ≥ nvalid[i]; the output is (NC, C) f32, C = 128.

On CUDA tensors `adc_scan` launches the hand-written Hopper kernel in
`csrc/adc_scan.cu` (built with nvcc at first use) or raises; on CPU tensors
it runs `adc_scan_reference`, the same sums in the same order in plain
PyTorch.  The two are bit-identical.  Which one runs depends only on where
the tensors live (`cuda_build.route`).

What the JAX package needed and the port does not: the (256·M, B) bf16
transposed LUT and its one-hot MXU product (the LUT here is the natural
(B, M, 256) f32 table, looked up directly, so the scores are exact f32), the
8,192-chunk segmenting of a call (scalar prefetch lived in SMEM), and the
128-query cap of a call (the MXU's result width).
"""

from __future__ import annotations

import torch

from . import cuda_build

LIBRARY = "adc_scan"
_SCAN = cuda_build.Kernel(LIBRARY, "crt_adc_scan")
CHUNK = 128  # code rows per worklist chunk; inverted lists start at multiples of it


def adc_scan_reference(
    codes: torch.Tensor,
    lut: torch.Tensor,
    blocks: torch.Tensor,
    nvalid: torch.Tensor,
    owner: torch.Tensor,
    coarse: torch.Tensor,
) -> torch.Tensor:
    """Plain version: gather each chunk's code rows, add the owner's LUT
    entries in sub-quantizer order in f32, add the coarse term, mask."""
    nc = blocks.shape[0]
    m = codes.shape[1]
    r = torch.arange(CHUNK, device=codes.device)
    chunk_codes = codes[blocks.long()[:, None] * CHUNK + r[None, :]]  # (NC, C, M) uint8
    own = owner.long()[:, None]
    acc = torch.zeros((nc, CHUNK), dtype=torch.float32, device=codes.device)
    for mm in range(m):
        acc = acc + lut[own, mm, chunk_codes[:, :, mm].long()]
    out = acc + coarse.float()[:, None]
    return torch.where(r[None, :] < nvalid[:, None], out, float("-inf"))


def _check(codes, lut, blocks, nvalid, owner, coarse) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if codes.dim() != 2 or codes.shape[0] % CHUNK or codes.shape[0] == 0:
        raise ValueError(f"codes must be (n·{CHUNK}, M) with n ≥ 1, got {tuple(codes.shape)}")
    m = codes.shape[1]
    if lut.dim() != 3 or lut.shape[1:] != (m, 256):
        raise ValueError(f"lut must be (B, {m}, 256), got {tuple(lut.shape)}")
    nc = blocks.shape[0]
    for name, t in (("blocks", blocks), ("nvalid", nvalid), ("owner", owner), ("coarse", coarse)):
        if t.shape != (nc,):
            raise ValueError(f"{name} must be ({nc},), got {tuple(t.shape)}")
    want = {"codes": (codes, torch.uint8), "lut": (lut, torch.float32), "blocks": (blocks, torch.int32),
            "nvalid": (nvalid, torch.int32), "owner": (owner, torch.int32), "coarse": (coarse, torch.float32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lut.data_ptr() % 16:
        raise ValueError("lut must start at a 16-byte aligned address (the kernel copies it 16 bytes at a time)")
    if nc >= 2**31 // CHUNK:
        raise ValueError(f"{nc} chunks exceed the kernel's int32 chunk index")


def code_width(codes: torch.Tensor) -> int:
    """Bytes the kernel reads at once from a code row: 16 when M % 16 == 0
    and the codes are 16-byte aligned, 4 when M % 4 == 0 and 4-byte aligned,
    else 1 (`crt_adc_scan`'s `vec`)."""
    m, ptr = codes.shape[1], codes.data_ptr()
    return 16 if m % 16 == 0 and ptr % 16 == 0 else (4 if m % 4 == 0 and ptr % 4 == 0 else 1)


def adc_scan(
    codes: torch.Tensor,  # (Na, M) uint8, Na % 128 == 0, every list start % 128 == 0
    lut: torch.Tensor,  # (B, M, 256) f32
    blocks: torch.Tensor,  # (NC,) int32 — code block of each chunk
    nvalid: torch.Tensor,  # (NC,) int32 — valid rows of each chunk (0 → all −inf)
    owner: torch.Tensor,  # (NC,) int32 — the query each chunk is scored for
    coarse: torch.Tensor,  # (NC,) f32 — q·centroid term of the chunk's list
) -> torch.Tensor:
    """ADC scores (NC, 128) f32, −inf past each chunk's nvalid.

    CUDA tensors: the dtypes above, contiguous, lut 16-byte aligned;
    anything else raises.  A chunk whose block or owner is out of range gives
    NaN on CUDA (the kernel reads only inside the arrays) and raises on the
    CPU.  CPU tensors: the plain reference."""
    tensors = (codes, lut, blocks, nvalid, owner, coarse)
    if cuda_build.route("adc_scan", *tensors) == "cpu":
        return adc_scan_reference(*tensors)
    _check(*tensors)
    nc, m = blocks.shape[0], codes.shape[1]
    out = torch.empty((nc, CHUNK), dtype=torch.float32, device=codes.device)
    if nc == 0:
        return out
    _SCAN.launch(adc_scan, codes.device, lambda: f"NC={nc} M={m} B={lut.shape[0]}",
                 codes.data_ptr(), codes.shape[0] // CHUNK, lut.data_ptr(), lut.shape[0], m, blocks.data_ptr(),
                 nvalid.data_ptr(), owner.data_ptr(), coarse.data_ptr(), out.data_ptr(), nc, code_width(codes))
    return out


adc_scan.launches = 0  # kernel launches, counted only where the kernel launches

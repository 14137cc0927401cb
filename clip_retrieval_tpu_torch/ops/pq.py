"""Product quantization (+ OPQ rotation) for the IVF-PQ tier.

Counterpart of `clip_retrieval_tpu/ops/pq.py`, with the same functions:

- codebook training: every sub-quantizer trains at once (`kmeans_multi`);
- encode: per-subspace argmax of x·cᵀ − ½‖c‖² → uint8 codes;
- ADC: query → (M, 256) look-up table by one batched product; scoring sums
  LUT entries (the serving scan is kernel K4, `ops/adc_scan.py`);
- OPQ: alternate between training PQ under a fixed rotation and solving the
  orthogonal Procrustes problem R = UVᵀ from SVD(xᵀ·x̂), then fit the final
  codebooks under the final rotation.

Tensors live on the device of the codebooks; host rows stream to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .kmeans import assign, kmeans_multi


@dataclasses.dataclass
class PQCodebooks:
    codebooks: torch.Tensor  # (M, ksub, dsub) f32
    rotation: torch.Tensor | None = None  # (d, d) f32, x @ rotation = rotated

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def d(self) -> int:
        return self.m * self.dsub


def split(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) → (m, n, dsub)."""
    n, d = x.shape
    return x.reshape(n, m, d // m).transpose(0, 1)


def encode(xs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """xs (M, n, dsub), codebooks (M, ksub, dsub) → (n, M) uint8 codes: per
    subspace argmax of x·cᵀ − ½‖c‖², in row blocks that bound the scores."""
    return assign(xs, codebooks).T.to(torch.uint8)


def pq_encode(x, pq: PQCodebooks, chunk: int = 1 << 17) -> np.ndarray:
    """Encode host rows in chunks on the codebooks' device → (n, M) uint8."""
    x = np.asarray(x, np.float32)
    dev = pq.codebooks.device
    out = np.empty((x.shape[0], pq.m), np.uint8)
    for i in range(0, x.shape[0], chunk):
        xc = torch.from_numpy(np.ascontiguousarray(x[i : i + chunk])).to(dev)
        if pq.rotation is not None:
            xc = xc @ pq.rotation
        out[i : i + chunk] = encode(split(xc, pq.m), pq.codebooks).cpu().numpy()
    return out


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(n, M) uint8 + (M, ksub, dsub) → (n, M·dsub) f32 (rotated space)."""
    n, m = codes.shape
    sub = torch.arange(m, device=codebooks.device)
    return codebooks[sub[None, :], codes.long()].reshape(n, -1)


def pq_reconstruct(codes, pq: PQCodebooks) -> torch.Tensor:
    """Decode and un-rotate back to the original space."""
    x = pq_decode(torch.as_tensor(np.asarray(codes)).to(pq.codebooks.device), pq.codebooks)
    if pq.rotation is not None:
        x = x @ pq.rotation.T
    return x


def adc_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Inner-product ADC tables: (B, d) × (M, ksub, dsub) → (B, M, ksub) f32."""
    b = queries.shape[0]
    m, _, dsub = codebooks.shape
    qs = queries.float().reshape(b, m, dsub).transpose(0, 1)  # (M, B, dsub)
    return torch.bmm(qs, codebooks.transpose(1, 2)).transpose(0, 1)


def adc_score(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, M, ksub) LUT × (n, M) codes → (B, n) approximate inner products,
    summed over the sub-quantizers."""
    m = codes.shape[1]
    sub = torch.arange(m, device=lut.device)
    return lut[:, sub[None, :], codes.long()].sum(-1)


def procrustes(x: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """argmin_R ‖xR − x̂‖_F over orthogonal R: R = UVᵀ, USVᵀ = svd(xᵀx̂)."""
    u, _, vt = torch.linalg.svd(x.T @ xhat, full_matrices=False)
    return u @ vt


def train_pq(x, m: int, ksub: int = 256, niter: int = 20, seed: int = 0, max_points: int = 1 << 19,
             device: str | torch.device = "cuda") -> PQCodebooks:
    """Train plain PQ codebooks on (a subsample of) host rows x (n, d)."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if d % m:
        raise ValueError(f"d={d} not divisible by m={m}")
    rng = np.random.default_rng(seed)
    if n > max_points:
        x = x[rng.choice(n, size=max_points, replace=False)]
    xs = np.ascontiguousarray(x.reshape(x.shape[0], m, d // m).transpose(1, 0, 2))
    return PQCodebooks(codebooks=kmeans_multi(xs, ksub, niter=niter, seed=seed, device=device), rotation=None)


def train_opq(x, m: int, ksub: int = 256, opq_iters: int = 8, pq_niter: int = 8, seed: int = 0,
              max_points: int = 1 << 18, device: str | torch.device = "cuda") -> PQCodebooks:
    """OPQ: an orthogonal rotation R minimizing ‖xR − decode(encode(xR))‖, by
    alternating PQ training and Procrustes; returns codebooks + rotation."""
    device = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    if n > max_points:
        x = x[rng.choice(n, size=max_points, replace=False)]
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    rotation = torch.eye(d, dtype=torch.float32, device=device)
    for it in range(max(opq_iters, 0)):
        xr = xd @ rotation
        pq_it = train_pq(xr.cpu().numpy(), m, ksub, niter=pq_niter, seed=seed + it, device=device)
        xhat = pq_decode(encode(split(xr, m), pq_it.codebooks), pq_it.codebooks)  # rotated space
        rotation = procrustes(xd, xhat)
    # the final codebooks are fitted under the FINAL rotation (the loop's
    # last PQ was trained under the previous one); covers opq_iters=0 too
    xr = xd @ rotation
    pq = train_pq(xr.cpu().numpy(), m, ksub, niter=pq_niter, seed=seed + opq_iters, device=device)
    return PQCodebooks(codebooks=pq.codebooks, rotation=rotation)

"""k-means (Lloyd's) for index training: coarse quantizers and PQ codebooks.

Counterpart of `clip_retrieval_tpu/ops/kmeans.py`, with the same semantics:

- assignment is argmax(x·cᵀ − ½‖c‖²) (L2 on unit vectors, and IP), ties to
  the lower centroid index (`torch.argmax`, like `jnp.argmax`);
- all-zero rows (the padding of the JAX package's chunked layout) do not vote;
- an empty cluster is re-seeded from the largest one:
  donor·(1 + eps) + eps with eps = 1e-4·(1 + arange(k)) per centroid row;
- subsampling draws from numpy `default_rng(seed)` in the same order, so both
  packages train on the same rows;
- k-means++ seeding by D²-sampling (Gumbel-max), from a `torch.Generator`.

What differs from the JAX package:
- `jax.random` cannot be reproduced, so the Lloyd loop is a function of its
  own, `lloyd`, that takes the initial centroids; given the same init it
  follows the JAX `_kmeans_jit`;
- the centroid update is a segment sum with `index_add_`, not the one-hot
  matmul the TPU needed for want of a fast scatter (half the operations);
- the assignment product is plain f32 on every device (TF32 off is the
  caller's setting, as the JAX package runs `jnp.dot` at its platform's
  default precision); no `mesh` argument and no relay chunking of the
  transfers: one explicit device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

ASSIGN_BYTES = 256 << 20  # bound on the (rows, k) f32 score block of one assignment step
UPLOAD_BYTES = 64 << 20  # host rows per transfer of assign_chunked


def scores(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(…, n, d), (…, k, d) → (…, n, k) L2-equivalent score x·cᵀ − ½‖c‖²."""
    return torch.matmul(x.float(), centroids.transpose(-1, -2)) - 0.5 * (centroids * centroids).sum(-1).unsqueeze(-2)


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row (int64), in blocks that bound the score matrix."""
    n, k = x.shape[-2], centroids.shape[-2]
    batch = int(np.prod(x.shape[:-2])) if x.dim() > 2 else 1
    step = max(256, ASSIGN_BYTES // max(1, 4 * k * batch))
    if n <= step:
        return torch.argmax(scores(x, centroids), dim=-1)
    return torch.cat([torch.argmax(scores(x[..., i : i + step, :], centroids), dim=-1) for i in range(0, n, step)],
                     dim=-1)


def assign_chunked(x, centroids: torch.Tensor, chunk: int | None = None) -> np.ndarray:
    """Stream host-resident rows through the assigner on `centroids.device`
    → (n,) int32.  fp16 rows travel as fp16 and widen on the device."""
    x = np.asarray(x)
    wire = x if x.dtype in (np.float16, np.float32) else x.astype(np.float32)
    if chunk is None:
        chunk = max(1, UPLOAD_BYTES // (wire.dtype.itemsize * max(1, int(np.prod(x.shape[1:])))))
    out = np.empty((x.shape[0],), np.int32)
    for i in range(0, x.shape[0], chunk):
        block = torch.from_numpy(np.ascontiguousarray(wire[i : i + chunk])).to(centroids.device)
        out[i : i + chunk] = assign(block, centroids).cpu().numpy()
    return out


def kmeanspp_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ D²-sampling seeds for (n, d) or (M, n, d) rows → (k, d) or
    (M, k, d) f32: each step samples a row with probability ∝ its squared
    distance to the nearest seed so far, by Gumbel-max on log-distances."""
    single = x.dim() == 2
    if single:
        x = x.unsqueeze(0)
    x = x.float()
    m, n, d = x.shape
    dev = x.device
    x2 = (x * x).sum(-1)  # (M, n)
    rows = torch.arange(m, device=dev)
    first = torch.randint(0, n, (m,), generator=generator, device=dev)
    cent = torch.zeros((m, k, d), dtype=torch.float32, device=dev)
    cent[:, 0] = x[rows, first]
    min_d2 = torch.full((m, n), float("inf"), device=dev)
    for i in range(1, k):
        c = cent[:, i - 1]  # (M, d): the seed added last
        d2 = x2 - 2.0 * torch.bmm(x, c.unsqueeze(-1)).squeeze(-1) + (c * c).sum(-1, keepdim=True)
        min_d2 = torch.minimum(min_d2, d2.clamp_min(0.0))
        u = torch.rand((m, n), generator=generator, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        idx = torch.argmax(torch.log(min_d2 + 1e-20) + gumbel, dim=1)
        cent[:, i] = x[rows, idx]
    return cent[0] if single else cent


def lloyd(x: torch.Tensor, init: torch.Tensor, niter: int) -> torch.Tensor:
    """Lloyd iterations from `init` over (n, d) or (M, n, d) rows → centroids
    of init's shape.  The JAX `_kmeans_jit` loop: all-zero rows do not vote,
    empty clusters are re-seeded from the largest one."""
    single = x.dim() == 2
    if single:
        x, init = x.unsqueeze(0), init.unsqueeze(0)
    x = x.float()
    m, n, d = x.shape
    k = init.shape[1]
    dev = x.device
    valid = (x != 0).any(-1).reshape(-1)  # (M·n,)
    offset = (torch.arange(m, device=dev) * k).repeat_interleave(n)  # subspace m owns rows [m·k, (m+1)·k) of the sums
    flat_x = x.reshape(m * n, d)
    if not bool(valid.all()):
        flat_x, offset = flat_x[valid], offset[valid]
    eps = 1e-4 * (1.0 + torch.arange(k, dtype=torch.float32, device=dev))[:, None]
    cent = init.float().clone()
    for _ in range(niter):
        a = assign(x, cent).reshape(-1)
        a = (a if a.shape == offset.shape else a[valid]) + offset
        sums = torch.zeros((m * k, d), dtype=torch.float32, device=dev).index_add_(0, a, flat_x)
        counts = torch.bincount(a, minlength=m * k).float().reshape(m, k)
        new = sums.reshape(m, k, d) / counts.clamp_min(1.0)[..., None]
        largest = torch.argmax(counts, dim=1)  # (M,)
        donor = new[torch.arange(m, device=dev), largest][:, None, :] * (1.0 + eps) + eps
        cent = torch.where((counts == 0)[..., None], donor, new)
    return cent[0] if single else cent


def _repeat_to(x: np.ndarray, k: int, axis: int) -> np.ndarray:
    """Tile rows along `axis` until there are at least k (JAX: n < k)."""
    n = x.shape[axis]
    if n >= k:
        return x
    return np.concatenate([x] * (-(-k // n)), axis=axis)


def kmeans(x, k: int, niter: int = 20, seed: int = 0, max_points: int = 1 << 21,
           device: str | torch.device = "cuda") -> torch.Tensor:
    """Train k centroids on (a subsample of) host rows x → (k, d) f32 on `device`."""
    device = resolve_device(device)
    if not hasattr(x, "shape"):  # list-of-vectors inputs stay accepted
        x = np.asarray(x)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if n > max_points:
        # subsample before the f32 conversion: a disk-backed corpus never
        # materializes in RAM
        x = x[np.sort(rng.choice(n, size=max_points, replace=False))]
        n = max_points
    x = np.asarray(x, np.float32)
    if n < k:
        x = _repeat_to(x, k, 0)[: max(k, n)]
        n = x.shape[0]
    init_rows = min(n, 1 << 18)
    init_x = x if n == init_rows else x[rng.choice(n, size=init_rows, replace=False)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init = kmeanspp_init(torch.from_numpy(np.ascontiguousarray(init_x)).to(device), k, gen)
    return lloyd(torch.from_numpy(x).to(device), init, niter)


def kmeans_multi(x, k: int, niter: int = 20, seed: int = 0, device: str | torch.device = "cuda") -> torch.Tensor:
    """k-means over each subspace of x (M, n, dsub) at once → (M, k, dsub)
    f32 on `device`: the PQ codebook trainer."""
    device = resolve_device(device)
    x = _repeat_to(np.asarray(x, np.float32), k, 1)
    m, n, dsub = x.shape
    rng = np.random.default_rng(seed)
    init_rows = min(n, 1 << 17)
    init_x = x if n == init_rows else x[:, rng.choice(n, size=init_rows, replace=False), :]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init = kmeanspp_init(torch.from_numpy(np.ascontiguousarray(init_x)).to(device), k, gen)
    return lloyd(torch.from_numpy(np.ascontiguousarray(x)).to(device), init, niter)

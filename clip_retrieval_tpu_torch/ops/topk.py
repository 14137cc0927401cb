"""Top-k for the brute-force and IVF search paths.

Counterpart of `clip_retrieval_tpu/ops/topk.py`.  The product is a plain
matrix product (in JAX it is outside any Pallas kernel too), then
`torch.topk`.  Ids are int64.
"""

from __future__ import annotations

import torch

from ..models.clip import matmul_f32


def topk_ip(queries: torch.Tensor, db: torch.Tensor, k: int):
    """Exact inner-product top-k: (B,d) × (N,d) → (B,k) scores, int64 ids.
    Queries are cast to db's dtype (fp16 for the flat index) and the product
    accumulates in f32, as in the JAX package."""
    vals, idx = torch.topk(matmul_f32(queries.to(db.dtype), db.T), k, dim=1)
    return vals, idx


def topk_merge(best_vals, best_ids, new_vals, new_ids, k: int):
    """Merge running (B,k) best with a new candidate block (B,c)."""
    vals = torch.cat([best_vals, new_vals], dim=1)
    ids = torch.cat([best_ids, new_ids], dim=1)
    mvals, midx = torch.topk(vals, k, dim=1)
    return mvals, torch.gather(ids, 1, midx)

"""Scaled-dot-product attention for the CLIP towers.

Counterpart of `clip_retrieval_tpu/ops/attention.py`.  The model's blocks
call `sdpa_packed` on the packed (B, S, W) projection layout; it goes to
kernel K1 (`flash.flash_attention_packed`).  The unpacked (B, H, S, dh)
entry `sdpa` goes to kernel K2 (`flash.flash_attention`) for impl 'auto' and
'flash'.  Each kernel wrapper launches the CUDA kernel for CUDA tensors and
runs the plain math for CPU tensors.  There is no environment switch and no
fallback between the two.  (The JAX package's 'auto' took 'xla_bf16' on the
TPU because its K2 lost there; no H100 measurement says the same, so 'auto'
is the kernel here.)
"""

from __future__ import annotations

import torch

from . import flash


def sdpa_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
    bf16_logits: bool = False,
) -> torch.Tensor:
    """Plain attention on (B, H, S, dh).

    bf16_logits=False: logits and softmax in f32.
    bf16_logits=True: logits rounded to bfloat16 before the max, exp and
    normalisation, which still run in f32 (the JAX package's 'xla_bf16'
    route).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -1e30)
    if bf16_logits:
        logits = logits.to(torch.bfloat16)
        mx = logits.amax(dim=-1, keepdim=True)
        p = torch.exp((logits - mx).float())
        probs = p / p.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
         impl: str = "auto") -> torch.Tensor:
    """Attention on (B, H, S, dh); k and v may have another sequence length.

    impl: 'auto' | 'flash' → kernel K2 (its plain version on CPU tensors);
    'xla' → `sdpa_reference` with f32 logits; 'xla_bf16' → with logits
    rounded to bfloat16 (the names of the JAX package's plain routes)."""
    if impl in ("auto", "flash"):
        return flash.flash_attention(q, k, v, causal=causal)
    if impl in ("xla", "xla_bf16"):
        return sdpa_reference(q, k, v, causal=causal, bf16_logits=impl == "xla_bf16")
    raise ValueError(f"impl must be auto|flash|xla|xla_bf16, got {impl!r}")


def sdpa_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    *,
    causal: bool = False,
) -> torch.Tensor:
    """Attention on the packed (B, S, W) projection layout, W = heads·dh:
    kernel K1 on CUDA tensors, its plain version on CPU tensors."""
    return flash.flash_attention_packed(q, k, v, heads, causal=causal)

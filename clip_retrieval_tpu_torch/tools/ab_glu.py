"""A/B of EVA02's SwiGLU MLP branch with its hidden padded to a multiple of 8
and unpadded, on one card.

    python3 -m clip_retrieval_tpu_torch.tools.ab_glu [--rounds 3]

One MLP branch of an EVA02-L/14-336 image block at batch 256, bf16, as
`models/clip.py` runs it: the gate product over [Wg | Wx] into an f32
accumulator (256·577, 2·hp), `block_fused.glu_layernorm`, then the product
with W_out (hp, 1024) and the residual epilogue.  hp is 2736 (the model's
2730 padded with zero columns to `GLU_ALIGN` = 8, so that bf16 and f32 rows
stay 16-byte aligned and the gate pass takes its 16-byte route) or 2730
(`GLU_ALIGN` = 1: rows of 5,460 bytes, the gate pass's scalar route, and a
product whose depth is not a multiple of 8).  Each part and the whole are
timed with CUDA events, in rounds of padded, unpadded, unpadded, padded;
both outputs are checked against each other (bf16, min row cosine).  Prints
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..models import clip as tclip
from ..ops import block_fused

ROWS, WIDTH, HIDDEN, EPS = 256 * 577, 1024, 2730, 1e-6


def _ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _branch(m: tclip.SwiGLU, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h, w_out = m.hidden(y, EPS)
    return tclip._dense(h, w_out, m.b_out, residual=x)


def _parts(m: tclip.SwiGLU, y: torch.Tensor, x: torch.Tensor, iters: int) -> dict:
    """ms of the gate product, the gate pass and the out product with its
    epilogue, each alone, at the current `GLU_ALIGN`."""
    pad = -HIDDEN % tclip.GLU_ALIGN
    cols = lambda t: torch.nn.functional.pad(t.to(y.dtype), (0, pad))  # noqa: E731
    w_gx = torch.cat((cols(m.w_gate), cols(m.w_in)), dim=-1)
    bias = torch.cat((torch.nn.functional.pad(m.b_gate, (0, pad)), torch.nn.functional.pad(m.b_in, (0, pad))))
    w_out = torch.nn.functional.pad(m.w_out, (0, 0, 0, pad))
    acc = tclip.matmul_f32(y, w_gx)
    h = block_fused.glu_layernorm(acc, bias, m.ln.scale, m.ln.bias, EPS, dtype=y.dtype)
    return {
        "gate_product_ms": _ms(lambda: tclip.matmul_f32(y, w_gx), iters),
        "gate_pass_ms": _ms(lambda: block_fused.glu_layernorm(acc, bias, m.ln.scale, m.ln.bias, EPS, dtype=y.dtype),
                            iters),
        "out_product_ms": _ms(lambda: tclip._dense(h, w_out, m.b_out, residual=x), iters),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    m = tclip.SwiGLU(WIDTH, HIDDEN, dev)
    with torch.no_grad():
        for p in (m.w_gate, m.w_in):
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * WIDTH ** -0.5)
        m.w_out.copy_(torch.randn(m.w_out.shape, generator=gen, device=dev) * HIDDEN ** -0.5)
        for p in (m.b_gate, m.b_in, m.b_out, m.ln.bias):
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    x = torch.randn(ROWS, WIDTH, generator=gen, device=dev).to(torch.bfloat16)
    y = torch.randn(ROWS, WIDTH, generator=gen, device=dev).to(torch.bfloat16)
    sides = {"padded": 8, "unpadded": 1}
    out, times, parts = {}, {k: [] for k in sides}, {}
    orig = tclip.GLU_ALIGN
    try:
        with torch.inference_mode():
            for name, align in sides.items():
                tclip.GLU_ALIGN = align
                out[name] = _branch(m, y, x)
                parts[name] = _parts(m, y, x, args.iters)
            for _ in range(args.rounds):
                for name in ("padded", "unpadded", "unpadded", "padded"):
                    tclip.GLU_ALIGN = sides[name]
                    times[name].append(_ms(lambda: _branch(m, y, x), args.iters))
    finally:
        tclip.GLU_ALIGN = orig
    cos = torch.nn.functional.cosine_similarity(out["padded"].float(), out["unpadded"].float(), dim=-1).min().item()
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(json.dumps({"card": card, "shape": [ROWS, WIDTH, HIDDEN], "branch_ms": times, "median_ms": med,
                      "padded_over_unpadded": med["padded"] / med["unpadded"], "parts": parts,
                      "outputs_min_row_cos": cos,
                      "outputs_equal_share": (out["padded"] == out["unpadded"]).float().mean().item()}))


if __name__ == "__main__":
    main()

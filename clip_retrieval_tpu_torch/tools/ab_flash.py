"""A/B of kernel K1 (`crt_flash_packed`) between two checkouts on one card.

    python3 -m clip_retrieval_tpu_torch.tools.ab_flash OTHER_CHECKOUT [--rounds 2]

Builds `clip_retrieval_tpu_torch/csrc/flash_packed.cu` of this checkout and
of OTHER_CHECKOUT (for example the parent commit unpacked with `git archive`
into a git-ignored directory) with the same nvcc flags into
`build/ab_flash/`, checks that both give the same output on the same inputs,
and times both with CUDA events at the towers' shapes: the image tower's
(256, 257, 16×64) and the text tower's (256, 77, 12×64, causal), bf16.  Each
round runs other, this, this, other, so a drift of the card's clock during
the run falls on both alike.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..ops.cuda_build import CHECKOUT, NVCC_FLAGS, nvcc_path

SHAPES = [(256, 257, 16, 64, False), (256, 77, 12, 64, True)]  # (B, S, heads, dh, causal)
BF16 = 1  # the dtype code of crt_flash_packed


def build(root: Path, tag: str) -> ctypes.CDLL:
    out = CHECKOUT / "build" / "ab_flash" / f"libflash_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = root / "clip_retrieval_tpu_torch" / "csrc" / "flash_packed.cu"
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crt_flash_packed.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.crt_flash_packed.restype = ci
    return lib


def launcher(lib: ctypes.CDLL, q, k, v, o, heads: int, causal: bool):
    b, s, w = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, heads, w // heads, int(causal), BF16, 1,
            stream)

    def run():
        rc = lib.crt_flash_packed(*args)
        if rc != 0:
            raise RuntimeError(f"crt_flash_packed returned {rc}")

    return run


def cuda_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    libs = {"other": build(args.other.resolve(), "other"), "this": build(CHECKOUT, "this")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, heads, dh, causal in SHAPES:
        q, k, v = (torch.randn(b, s, heads * dh, generator=gen, device="cuda").bfloat16() for _ in range(3))
        outs = {name: torch.empty_like(q) for name in libs}
        runs = {name: launcher(lib, q, k, v, outs[name], heads, causal) for name, lib in libs.items()}
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        times: dict[str, list[float]] = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                times[name].append(cuda_ms(runs[name], args.iters))
        rows.append({"shape": [b, s, heads, dh], "causal": causal,
                     "max_abs_diff": (outs["this"].float() - outs["other"].float()).abs().max().item(),
                     "ms": times, "this_over_other": sum(times["this"]) / sum(times["other"])})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "other": str(args.other), "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""A/B of kernels K1 (`crt_flash_packed`) and K2 (`crt_flash_bhsd`) between checkouts on one card.

    python3 -m clip_retrieval_tpu_torch.tools.ab_flash OTHER_CHECKOUT [MORE_CHECKOUTS ...] [--rounds 2]

Builds `clip_retrieval_tpu_torch/csrc/flash_packed.cu` of this checkout and
of each other checkout (for example the parent commit unpacked with `git
archive` into a git-ignored directory, or a variant of this source) with the
same nvcc flags into `build/ab_flash/`, in parallel, checks that each gives
this checkout's output on the same inputs (bf16 max abs and min row cosine),
reports each build's bf16 kernels as `nvcc -Xptxas -v` gives them
(registers, spill stores and loads, by mangled name), and times all with
CUDA events, bf16, at the towers' shapes: K1 at ViT-L/14's image (256, 257,
16×64) and text (256, 77, 12×64, causal) shapes and SigLIP So400m/384's
image (256, 729, 16×72) and bidirectional text (256, 64, 16×72) shapes, K2
at (256, 16, 257, 64), (256, 12, 77, 64, causal) and (256, 16, 729, 72),
and K1 at the other head widths above 64 that pick the route per padded
width (ViT-H/14's 16×80 and ViT-g/14's 16×88 at S 257, and 8×128).  Each
row carries its bound (q, k, v and o moved once over 3.35 TB/s against the
products over 989 TFLOP/s).  `F.scaled_dot_product_attention` on the
same inputs in the (B, H, S, dh) layout is timed beside them as the
yardstick; the port never calls it.  Each round runs SDPA, the others, this,
this, the others in reverse, SDPA, so a drift of the card's clock during the
run falls on all alike.  `this_over_other` compares with the first other
checkout.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops.cuda_build import CHECKOUT, NVCC_FLAGS, declare, nvcc_path

# (entry, B, S, heads, dh, causal)
SHAPES = [("packed", 256, 257, 16, 64, False), ("packed", 256, 77, 12, 64, True),
          ("bhsd", 256, 257, 16, 64, False), ("bhsd", 256, 77, 12, 64, True),
          ("packed", 256, 729, 16, 72, False), ("packed", 256, 64, 16, 72, False),
          ("bhsd", 256, 729, 16, 72, False),
          ("packed", 256, 257, 16, 80, False), ("packed", 256, 257, 16, 88, False),
          ("packed", 256, 257, 8, 128, False)]
BF16 = 1  # the dtype code of both entries
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM data sheet


def bound_ms(b: int, s: int, heads: int, dh: int, causal: bool) -> float:
    """The least time of one bf16 call: q, k, v and o moved once, or the
    products (the causal half where causal), whichever takes longer."""
    pairs = s * (s + 1) / 2 if causal else s * s
    return 1e3 * max(4 * b * heads * s * dh * 2 / HBM_BYTES_PER_S, 4 * b * heads * pairs * dh / BF16_FLOPS)


def _short(mangled: str) -> str | None:
    m = re.search(r"(flash_(?:bf16|wgmma)_kernel(?:I\w*?E)?)E", mangled)
    return m.group(1) if m else None


def ptxas_report(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads[, warnings]}} for the bf16
    kernels in `nvcc -Xptxas -v` output (mangled names shortened to the
    kernel and its template arguments); `warnings` holds ptxas's warnings
    about the kernel, such as C7520 (wgmma serialised)."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"ptxas warning\s*:\s*(.*)in the function '(\S+)'", line)
        if m and _short(m.group(2)):
            report.setdefault(_short(m.group(2)), {}).setdefault("warnings", []).append(m.group(1).strip())
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _short(m.group(1))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(name, {})["registers"] = int(m.group(1))
    return report


def build(root: Path, tag: str) -> tuple[ctypes.CDLL, dict]:
    out = CHECKOUT / "build" / "ab_flash" / f"libflash_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = root / "clip_retrieval_tpu_torch" / "csrc" / "flash_packed.cu"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    return declare(ctypes.CDLL(str(out)), "flash_packed"), ptxas_report(proc.stdout + proc.stderr)


def launcher(lib: ctypes.CDLL, entry: str, q, k, v, o, heads: int, causal: bool):
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if entry == "packed":
        b, s, w = q.shape
        fn, args = lib.crt_flash_packed, (*ptrs, b, s, heads, w // heads, int(causal), BF16, 1, stream)
    else:
        b, h, s, dh = q.shape
        fn, args = lib.crt_flash_bhsd, (*ptrs, b, h, s, k.shape[2], dh, int(causal), BF16, 1, stream)

    def run():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"crt_flash_{entry} returned {rc}")

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
    ap.add_argument("others", type=Path, nargs="+", help="roots of the other checkouts")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    roots = {f"other{i}": root.resolve() for i, root in enumerate(args.others)}
    roots["this"] = CHECKOUT
    with ThreadPoolExecutor(len(roots)) as pool:
        built = dict(zip(roots, pool.map(build, roots.values(), roots)))
    libs = {name: lib for name, (lib, _) in built.items()}
    others = [name for name in libs if name != "this"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for entry, b, s, heads, dh, causal in SHAPES:
        shape = (b, s, heads * dh) if entry == "packed" else (b, heads, s, dh)
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        if entry == "packed":  # SDPA takes (B, H, S, dh): the head transposes are not timed
            qs, ks, vs = (x.view(b, s, heads, dh).transpose(1, 2).contiguous() for x in (q, k, v))
        else:
            qs, ks, vs = q, k, v
        outs = {name: torch.empty_like(q) for name in libs}
        runs = {name: launcher(lib, entry, q, k, v, outs[name], heads, causal) for name, lib in libs.items()}
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        for fn in runs.values():  # warm up; SDPA's first calls pick a backend
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        times: dict[str, list[float]] = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name in ("sdpa", *others, "this", "this", *others[::-1], "sdpa"):
                times[name].append(cuda_ms(runs[name], args.iters))
        a = outs["this"].float().reshape(-1, dh)
        diff = {name: {"max_abs_diff": (a - outs[name].float().reshape(-1, dh)).abs().max().item(),
                       "min_row_cos": F.cosine_similarity(a, outs[name].float().reshape(-1, dh), dim=-1).min().item()}
                for name in others}
        mean = {name: sum(t) / len(t) for name, t in times.items()}
        rows.append({"entry": entry, "shape": [b, s, heads, dh], "causal": causal, "vs_this": diff, "ms": times,
                     "mean_ms": mean, "bound_ms": bound_ms(b, s, heads, dh, causal),
                     "this_over_other": mean["this"] / mean[others[0]],
                     "this_over_sdpa": mean["this"] / mean["sdpa"]})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "others": {name: str(root) for name, root in roots.items()},
                      "ptxas": {name: report for name, (_, report) in built.items()}, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

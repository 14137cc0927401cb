"""A/B of the towers' denses on one card: the one-kernel GEMM with its
epilogue (`crt_dense_gemm`) against the split route and cuBLAS alone.

    python3 -m clip_retrieval_tpu_torch.tools.ab_dense [OTHER_CHECKOUT ...] [--variant NAME=kStages:2 ...]
        [--modes] [--rounds 2] [--only NAME_PART]

At every `_dense` shape of the benchmark's three cells at batch 256 (SigLIP
So400m/384's image and text towers, ViT-L/14's, EVA02-L/14-336's image v, wo
and fc2 and its text tower, and the three patch embeddings, whose im2col rows
of 588 lie 592 apart) and at 1 to 8192 rows of SigLIP's and ViT-L/14's text
shapes (the sweep that sets `block_fused.GEMM_DEEP_K`: at few rows the split
route's cuBLAS splits a deep K over the SMs the kernel's few tiles leave
idle), bf16, times with CUDA events:

- `gemm`: `csrc/dense_gemm.cu` of this checkout (and `gemm_<i>` of each
  other checkout named, and each `--variant`: this source with the named
  `constexpr int` constants set otherwise), built with the package's nvcc
  flags into `build/ab_dense/`, in parallel; with `--modes`, `gemm_d0` to
  `gemm_d3`: this build with the consumer warps running 0-3 of each tile's
  64-column groups of the epilogue (what `block_fused.GEMM_DIRECT` picks
  from);
- `split`: `torch.mm(..., out_dtype=torch.float32)` and
  `block_fused.dense_epilogue` over it, the split route as `_dense` runs it;
- `mm`: `torch.mm` alone with a bf16 output, the library's product without
  the epilogue (the yardstick: at least this much time is the product's).

Each row carries its bound (2·M·N·K FLOPs over 989 TFLOP/s, or x, w, the
residual and the bf16 output moved once over 3.35 TB/s, whichever is
longer) and each build's output against the split route's (the largest
difference in bf16 ulps of the split output, and the share of equal
elements: the two sum the products in other orders).  Each round runs
split, mm, the others, this, this, the others in reverse, mm, split.
`blocks` sums a tower block's calls.  Reports each build's kernel as `nvcc
-Xptxas -v` gives it (registers, spills, warnings such as C7520) and the
card's name and power limit; prints one JSON line and writes it to
`chiprun_out/ab_dense.json`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import block_fused
from ..ops.cuda_build import CHECKOUT, NVCC_FLAGS, declare, nvcc_path

HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM data sheet
PATCH_K, PATCH_LDA = 588, 592  # 14·14·3, and the im2col's row stride
# tower: (rows, width, MLP hidden, activation, its calls); a call: (name, K, N, act, residual, count)
TOWERS = {
    "siglip_image": (256 * 729, 1152, 4304, "gelu_tanh", ("qkv", "wo", "fc1", "fc2")),
    "siglip_text": (256 * 64, 1152, 4304, "gelu_tanh", ("qkv", "wo", "fc1", "fc2")),
    "vitl_image": (256 * 257, 1024, 4096, "quick_gelu", ("qkv", "wo", "fc1", "fc2")),
    "vitl_text": (256 * 77, 768, 3072, "quick_gelu", ("qkv", "wo", "fc1", "fc2")),
    "eva_image": (256 * 577, 1024, 2736, None, ("v", "wo", "fc2")),  # q, k and the gate take other kernels
    "eva_text": (256 * 77, 768, 3072, "gelu", ("qkv", "wo", "fc1", "fc2")),
}
COUNT = {"qkv": 3, "v": 1, "wo": 1, "fc1": 1, "fc2": 1}
PATCHES = {"siglip_patch": (256 * 729, 1152, True), "vitl_patch": (256 * 256, 1024, False),
           "eva_patch": (256 * 576, 1024, True)}
SWEEP_ROWS = (1, 16, 77, 128, 256, 1024, 2048, 4096, 8192)


def shapes() -> list[dict]:
    """Every timed call: name, M, K, N, lda, act, bias, residual, and the
    tower block it belongs to with its count there."""
    out = []
    for tower, (m, w, h, act, calls) in TOWERS.items():
        for call in calls:
            k, n = {"qkv": (w, w), "v": (w, w), "wo": (w, w), "fc1": (w, h), "fc2": (h, w)}[call]
            out.append(dict(name=f"{tower}.{call}", m=m, k=k, n=n, lda=k, act=act if call == "fc1" else None,
                            bias=True, residual=call in ("wo", "fc2"), block=tower, count=COUNT[call]))
    for name, (m, n, bias) in PATCHES.items():
        out.append(dict(name=name, m=m, k=PATCH_K, n=n, lda=PATCH_LDA, act=None, bias=bias, residual=False,
                        block=None, count=1))
    for m in SWEEP_ROWS:
        for call, k, n, act, residual in (("qkv", 1152, 1152, None, False), ("fc1", 1152, 4304, "gelu_tanh", False),
                                          ("fc2", 4304, 1152, None, True), ("text_qkv", 768, 768, None, False),
                                          ("text_fc2", 3072, 768, None, True)):
            out.append(dict(name=f"sweep.{call}.m{m}", m=m, k=k, n=n, lda=k, act=act, bias=True, residual=residual,
                            block=None, count=1))
    return out


def bound_ms(s: dict) -> float:
    moved = 2 * (s["m"] * s["k"] + s["k"] * s["n"] + s["m"] * s["n"] * (2 if s["residual"] else 1))
    return 1e3 * max(2 * s["m"] * s["n"] * s["k"] / BF16_FLOPS, moved / HBM_BYTES_PER_S)


def ptxas_report(log: str) -> dict:
    """{registers, spill_stores, spill_loads, warnings} of `dense_gemm_kernel`
    (warnings: ptxas's about it, such as C7520, a wgmma serialised, or C7508,
    setmaxnreg ignored)."""
    rep, inside = {"warnings": []}, False
    for line in log.splitlines():
        if "ptxas warning" in line and "dense_gemm_kernel" in line:
            rep["warnings"].append(line.split("ptxas warning", 1)[1].strip(" :"))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inside = "dense_gemm_kernel" in m.group(1)
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rep.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep["registers"] = int(m.group(1))
    return rep


def variant_root(name: str, spec: str) -> Path:
    """A tree under `build/ab_dense/` holding this checkout's csrc/ with the
    `constexpr int` constants of `dense_gemm.cu` that `spec` names
    ("kStages:2") set to its values."""
    csrc = CHECKOUT / "clip_retrieval_tpu_torch" / "csrc"
    root = CHECKOUT / "build" / "ab_dense" / name
    dst = root / "clip_retrieval_tpu_torch" / "csrc"
    dst.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (dst / header.name).write_text(header.read_text())
    src = (csrc / "dense_gemm.cu").read_text()
    for item in spec.split(","):
        const, value = item.split(":")
        src, hits = re.subn(rf"constexpr int {const} = [^;]+;", f"constexpr int {const} = {value};", src)
        if hits != 1:
            raise ValueError(f"dense_gemm.cu has no single constant {const}")
    (dst / "dense_gemm.cu").write_text(src)
    return root


def build(root: Path, tag: str) -> tuple[ctypes.CDLL, dict]:
    out = CHECKOUT / "build" / "ab_dense" / f"libdense_gemm_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = root / "clip_retrieval_tpu_torch" / "csrc" / "dense_gemm.cu"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    return declare(ctypes.CDLL(str(out)), "dense_gemm"), ptxas_report(proc.stdout + proc.stderr)


def cuda_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ulps(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(largest |got − want| in bf16 ulps of want, share of equal elements)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(w.abs())
    ulp = torch.ldexp(torch.ones_like(w), (e - 8).to(torch.int32))
    return ((g - w).abs() / ulp).max().item(), (g == w).float().mean().item()


def run_shape(s: dict, libs: dict, rounds: int, iters: int, gen: torch.Generator, both=False) -> dict:
    dev = torch.device("cuda")
    m, k, n = s["m"], s["k"], s["n"]
    x = (torch.randn(m, s["lda"], generator=gen, device=dev) * 0.5).to(torch.bfloat16)[:, :k]
    w = (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device=dev) * 0.1 if s["bias"] else None
    res = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16) if s["residual"] else None
    act = block_fused.ACT_CODE[s["act"]]
    outs = {name: torch.empty(m, n, dtype=torch.bfloat16, device=dev) for name in libs}
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def gemm(name, direct=None):
        fn, out = libs[name].crt_dense_gemm, outs[name]
        direct = block_fused.GEMM_DIRECT[s["act"]][res is not None] if direct is None else direct
        args = (x.data_ptr(), w.data_ptr(), ptr(bias), ptr(res), out.data_ptr(), m, n, k, x.stride(0), act, 0,
                direct)

        def go():
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"crt_dense_gemm returned {rc} at {s['name']}")
        return go

    def split():
        acc = torch.mm(x, w, out_dtype=torch.float32)
        return block_fused.dense_epilogue(acc, bias, act=s["act"], residual=res, dtype=torch.bfloat16)

    runs = {"split": split, "mm": lambda: torch.mm(x, w), **{name: gemm(name) for name in libs},
            **({f"gemm_d{d}": gemm("gemm", d) for d in range(4)} if both else {})}
    want = split()
    row = {k_: s[k_] for k_ in ("name", "m", "k", "n", "lda", "act", "bias", "residual")}
    row["bound_ms"], row["check"] = bound_ms(s), {}
    for name, fn in runs.items():  # every run once before the timing (builds, cuBLAS's first call), checked
        fn()
        if name.startswith("gemm"):
            torch.cuda.synchronize()
            got = outs[name if name in libs else "gemm"]
            row["check"][name] = dict(zip(("max_ulps", "equal_share"), _ulps(got, want)))
    del want
    times = {name: [] for name in runs}
    others = [name for name in runs if name.startswith("gemm_")]
    order = ["split", "mm", *others, "gemm", "gemm", *others[::-1], "mm", "split"]
    for _ in range(rounds):
        for name in order:
            times[name].append(cuda_ms(runs[name], iters))
    row["ms"] = {name: statistics.median(v) for name, v in times.items()}
    row["gemm_over_mm"] = row["ms"]["gemm"] / row["ms"]["mm"]
    row["gemm_over_split"] = row["ms"]["gemm"] / row["ms"]["split"]
    row["gemm_roofline"] = 100.0 * row["bound_ms"] / row["ms"]["gemm"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", type=Path, nargs="*", help="roots of other checkouts whose dense_gemm.cu to time")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=SPEC",
                    help="time this source with constants set otherwise, e.g. s2=kStages:2")
    ap.add_argument("--modes", action="store_true",
                    help="also time this build with each share of the epilogue its consumer warps run (0-3)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--only", default="", help="time only the calls whose name contains this")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    roots = {"gemm": CHECKOUT, **{f"gemm_{i}": root.resolve() for i, root in enumerate(args.others)}}
    for v in args.variant:
        name, spec = v.split("=", 1)
        roots[f"gemm_{name}"] = variant_root(name, spec)
    with ThreadPoolExecutor(len(roots)) as pool:
        built = dict(zip(roots, pool.map(build, roots.values(), roots)))
    libs = {name: lib for name, (lib, _) in built.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    with torch.inference_mode():
        block_fused.dense_epilogue(torch.zeros(8, 8, device="cuda"), dtype=torch.bfloat16)  # build it first
        for s in shapes():
            if args.only in s["name"]:
                rows.append(run_shape(s, libs, args.rounds, args.iters, gen, args.modes))
                torch.cuda.empty_cache()
    blocks = {}
    for s, row in zip([s for s in shapes() if args.only in s["name"]], rows):
        if s["block"] is not None:
            b = blocks.setdefault(s["block"], {name: 0.0 for name in row["ms"]} | {"bound": 0.0})
            for name, ms in row["ms"].items():
                b[name] += s["count"] * ms
            b["bound"] += s["count"] * row["bound_ms"]
    result = {"card": card, "ptxas": {name: rep for name, (_, rep) in built.items()}, "blocks_ms": blocks,
              "rows": rows}
    line = json.dumps(result)
    out = CHECKOUT / "chiprun_out" / "ab_dense.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""A/B of kernel K4 (`crt_adc_scan`) between checkouts on one card.

    python3 -m clip_retrieval_tpu_torch.tools.ab_adc [OTHER_CHECKOUT ...] [--variants NAME ...]
        [--ablations NAME ...] [--rounds 2]

Builds `clip_retrieval_tpu_torch/csrc/adc_scan.cu` of this checkout and of
each other checkout (for example the parent commit unpacked with `git
archive` into a git-ignored directory, or a variant of this source) with the
same nvcc flags into `build/ab_adc/`, in parallel, and reports each build's
kernels as `nvcc -Xptxas -v` gives them (registers, spill stores and loads,
static shared memory; the LUT's dynamic shared memory is M·1 KB on top).

The worklists are those of the served geometry: a synthetic IVF-PQ index of
1,000,000 rows, nlist 1024 with list sizes from a random assignment, M 64
(d 768), staged by the port's own `IVFPQIndex`, and the chunk worklists its
device route builds (`ivfpq._worklist`, static budget) for B=32 queries at
nprobe 32 and 256 and B=1 at nprobe 1, 8, 32 and 64 (NC 16 to 1024); and
B=32 at nprobe 64 on the same geometry with skewed list sizes (exponential
list weights), where most of the static budget's chunks are empty, as on
the index the smoke builds with `clip_index`.  Each worklist runs with
uniform-random codes and with all-equal codes: the latter read one LUT entry
per sub-quantizer, so no lookup meets a bank conflict, and the difference is
what the conflicted lookups cost.

Every build must give bit-identical output to this checkout's, and this
checkout's to the plain version.  `--variants` adds builds of this
checkout's source with one constant changed (`VARIANTS`, same output);
`--ablations` adds builds with one part of the kernel removed (`ABLATIONS`:
no code loads, the codes made from their addresses; no LUT lookups, the code
bytes themselves added), whose output differs and is not checked.
Times are device times per call from CUDA
graph replay (a graph of many launches, timed with CUDA events), so the
host's launch cost does not enter the B=1 times; the worklist's codes stay
in the 50 MB L2 between launches where they fit.  Beside the builds,
`torch.nn.functional.embedding_bag(idx, lut.reshape(-1, 1), mode="sum")`
(idx = owner·M·256 + m·256 + code, int32, built before the timed region)
computes the same sums as the yardstick; the port never calls it.  Each
round runs embedding_bag, the others, this, this, the others in reverse,
embedding_bag.  `this_over_other` compares with the first other checkout.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda_build import CHECKOUT, NVCC_FLAGS, declare, nvcc_path

# the card's published peaks (H100 SXM data sheet): HBM bytes/s, SMs; shared-memory lookups per clock per SM
HBM_BPS, SMS, LOOKUPS_PER_CLK = 3.35e12, 132, 32
# the served geometry: rows, lists, width, sub-quantizers
ROWS, NLIST, DIM, M = 1_000_000, 1024, 768, 64
# (B, nprobe, lists): list sizes from a uniform random assignment, or skewed (below)
WORKLISTS = [(32, 32, "uniform"), (32, 256, "uniform"), (1, 1, "uniform"), (1, 8, "uniform"), (1, 32, "uniform"),
             (1, 64, "uniform"), (32, 64, "skewed")]
_LOAD = "      if (i < nq) w[i] = __ldg(rows + 32 * i + nq * ln.g + ((ln.k + i) & (nq - 1)));"
_LOOKUP = ("  for (int e = 0; e < 16; ++e) a = __fadd_rn(a, s_lut[e * 256 + ((words[e >> 2] >> (8 * (e & 3))) & "
           "0xffu)]);")
# this checkout's adc_scan.cu with lines replaced: [(old, new), ...]
_WAVES, _SPAN = "constexpr int kWaves = 8;", "constexpr int kMinSpan = 8;"
VARIANTS = {
    **{f"waves_{w}": [(_WAVES, f"constexpr int kWaves = {w};")] for w in (4, 16)},
    "min_span_1": [(_SPAN, "constexpr int kMinSpan = 1;")],
    **{f"threads_{t}": [("constexpr int kThreads = 256;", f"constexpr int kThreads = {t};")] for t in (384, 512)},
}
ABLATIONS = {
    "no_code_loads": [(_LOAD, "      if (i < nq) { const uint32_t x = (uint32_t)(size_t)(rows + 32 * i + ln.lane) "
                              "* 2654435761u; w[i] = make_uint4(x, x ^ 0x9e3779b9u, x ^ 0x7f4a7c15u, "
                              "x ^ 0x2545f491u); }")],
    "no_lookups": [(_LOOKUP, _LOOKUP.replace("s_lut[e * 256 + ((words[e >> 2] >> (8 * (e & 3))) & 0xffu)]",
                                             "(float)((words[e >> 2] >> (8 * (e & 3))) & 0xffu)"))],
}


def served_worklist(ix, qr: torch.Tensor, nprobe: int):
    """K4's arguments for the queries qr (rotated) at nprobe, as the device
    route of `IVFPQIndex._search_device` builds them (the largest bucket on
    the bucket route).  Returns (args, route, chunks per query)."""
    from ..index.ivfpq import _worklist, probe

    dv = ix._ensure_device()
    probe_vals, probe_idx = probe(qr, dv["coarse"], nprobe)
    buckets, bucketed = ix._chunk_buckets(dv, probe_idx, nprobe)
    nchunk_q = max(buckets)
    args, _, _ = _worklist(qr, probe_vals, probe_idx, dv, nchunk_q)
    return args, "budget buckets, the largest" if bucketed else "static budget", nchunk_q


def k4_bound(args, clock_hz: float) -> dict:
    """Least time of one K4 call on the worklist `args`: the bytes it must
    move (the valid code rows, the LUT, the four per-chunk scalars, the
    output) over the HBM rate against its LUT lookups (valid rows × M) at 32
    a clock on every SM at the card's clock; the larger of the two."""
    codes, lut, blocks, nvalid = args[:4]
    nc, m = blocks.shape[0], codes.shape[1]
    valid_rows = int(nvalid.clamp(min=0).sum().item())
    nbytes = valid_rows * m + lut.numel() * 4 + nc * 16 + nc * 128 * 4
    lookups = valid_rows * m
    t_bytes, t_ops = nbytes / HBM_BPS, lookups / (SMS * LOOKUPS_PER_CLK * clock_hz)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "lookups": lookups, "bytes_ms": 1e3 * t_bytes, "lookups_ms": 1e3 * t_ops,
            "nc": nc, "valid_rows": valid_rows}


def bag_inputs(args) -> tuple[torch.Tensor, torch.Tensor]:
    """embedding_bag's inputs for the same sums: idx (NC·128, M) int32 =
    owner·M·256 + m·256 + code, weight (B·M·256, 1) = the LUT."""
    codes, lut, blocks, _, owner, _ = args
    m, dev = codes.shape[1], codes.device
    idx = torch.empty((blocks.shape[0] * 128, m), dtype=torch.int32, device=dev)
    sub = torch.arange(m, device=dev, dtype=torch.int32) * 256
    step = 1 << 13  # chunks per piece: bounds the int64 transients
    for a in range(0, blocks.shape[0], step):
        rows = (blocks[a : a + step].long()[:, None] * 128 + torch.arange(128, device=dev)).reshape(-1)
        base = (owner[a : a + step] * (m * 256)).repeat_interleave(128)[:, None] + sub
        idx[a * 128 : a * 128 + rows.shape[0]] = base + codes[rows].int()
    return idx, lut.reshape(-1, 1)


def bag_check(args, idx, weight) -> float:
    """Max abs difference of embedding_bag's sums (+ coarse) from the plain
    version's on the valid rows: it computes the same function up to the
    order of its sums."""
    from ..ops.adc_scan import adc_scan_reference

    ref = adc_scan_reference(*args)
    got = torch.nn.functional.embedding_bag(idx, weight, mode="sum").reshape(ref.shape) + args[5][:, None]
    fin = torch.isfinite(ref)
    return (got[fin] - ref[fin]).abs().max().item() if bool(fin.any()) else 0.0


def graph_ms(fn, iters: int) -> float:
    """Device ms per call of fn: `iters` calls captured in one CUDA graph,
    one replay timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clock_max_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """{kernel<VEC>: {registers, spill_stores, spill_loads, static_smem}} from
    `nvcc -Xptxas -v` output (mangled names shortened)."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(r"(adc_\w*?kernel)ILi(\d+)EE", m.group(1))
            name = f"{short.group(1)}<{short.group(2)}>" if short else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            report.setdefault(name, {}).update(registers=int(m.group(1)), static_smem=int(smem.group(1)) if smem else 0)
    return report


def build(root: Path, tag: str) -> tuple[ctypes.CDLL, dict]:
    out = CHECKOUT / "build" / "ab_adc" / f"libadc_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = root / "clip_retrieval_tpu_torch" / "csrc" / "adc_scan.cu"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    return declare(ctypes.CDLL(str(out)), "adc_scan"), ptxas_report(proc.stdout + proc.stderr)


def variant_root(name: str, edits: list[tuple[str, str]]) -> Path:
    """A checkout root under build/ab_adc/ holding this checkout's
    adc_scan.cu with each line `old` replaced by `new`."""
    src = (CHECKOUT / "clip_retrieval_tpu_torch" / "csrc" / "adc_scan.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is not exactly once in adc_scan.cu")
        src = src.replace(old, new)
    root = CHECKOUT / "build" / "ab_adc" / "variants" / name
    dst = root / "clip_retrieval_tpu_torch" / "csrc" / "adc_scan.cu"
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(src)
    return root


def launcher(lib: ctypes.CDLL, args):
    """A call of one build's `crt_adc_scan` on args, as the wrapper makes it."""
    from ..ops.adc_scan import code_width

    codes, lut, blocks, nvalid, owner, coarse = args
    nc, m, vec = blocks.shape[0], codes.shape[1], code_width(codes)

    def run():
        out = torch.empty((nc, 128), dtype=torch.float32, device=codes.device)
        rc = lib.crt_adc_scan(codes.data_ptr(), codes.shape[0] // 128, lut.data_ptr(), lut.shape[0], m,
                              blocks.data_ptr(),
                              nvalid.data_ptr(), owner.data_ptr(), coarse.data_ptr(), out.data_ptr(), nc, vec,
                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"crt_adc_scan returned {rc}")
        return out

    return run


def served_index(skewed: bool, seed: int = 0):
    """A synthetic served-geometry IVF-PQ index on the card and 32 rotated
    queries (no rotation: the queries are random unit vectors).  Rows go to
    lists by a uniform random assignment, or (skewed) with exponentially
    distributed list weights, as trained lists over clustered rows come out:
    the static chunk budget then holds mostly empty chunks."""
    from ..index.ivfpq import IVFPQIndex

    rng = np.random.default_rng(seed)
    weights = rng.exponential(size=NLIST) if skewed else np.ones(NLIST)
    sizes = np.bincount(rng.choice(NLIST, ROWS, p=weights / weights.sum()), minlength=NLIST)
    offsets = np.zeros(NLIST + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    coarse = rng.standard_normal((NLIST, DIM), dtype=np.float32)
    coarse /= np.linalg.norm(coarse, axis=1, keepdims=True)
    codebooks = rng.standard_normal((M, 256, DIM // M), dtype=np.float32) * 0.1
    codes = rng.integers(0, 256, (ROWS, M), dtype=np.uint8)
    ix = IVFPQIndex(DIM, coarse, codebooks, None, offsets, np.arange(ROWS, dtype=np.int64), codes, device="cuda")
    ix._ensure_device()
    q = rng.standard_normal((32, DIM), dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return ix, torch.from_numpy(q).cuda()


def main(argv=None) -> int:
    from ..ops.adc_scan import adc_scan_reference

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", type=Path, nargs="*", help="roots of the other checkouts")
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--ablations", nargs="*", default=[], choices=sorted(ABLATIONS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    roots = {f"other{i}": root.resolve() for i, root in enumerate(args.others)}
    roots.update({name: variant_root(name, VARIANTS[name]) for name in args.variants})
    roots.update({name: variant_root(name, ABLATIONS[name]) for name in args.ablations})
    if not roots:
        ap.error("name another checkout, a variant or an ablation")
    roots["this"] = CHECKOUT
    with ThreadPoolExecutor(len(roots)) as pool:
        built = dict(zip(roots, pool.map(build, roots.values(), roots)))
    libs = {name: lib for name, (lib, _) in built.items()}
    others = [name for name in libs if name != "this"]
    clock = clock_max_hz()
    indices = {lists: served_index(lists == "skewed") for lists in sorted({w[2] for w in WORKLISTS})}
    rows = []
    for b, nprobe, lists in WORKLISTS:
        ix, q = indices[lists]
        wl, route, nchunk_q = served_worklist(ix, q[:b], nprobe)
        for kind in ("uniform", "equal"):
            a = wl if kind == "uniform" else (torch.full_like(wl[0], 7), *wl[1:])
            bound = k4_bound(a, clock)
            outs = {name: launcher(lib, a)() for name, lib in libs.items()}
            ref = adc_scan_reference(*a)
            torch.cuda.synchronize()
            identical = {name: bool(torch.equal(outs[name], outs["this"])) for name in others
                         if name not in ABLATIONS}
            identical["plain"] = bool(torch.equal(outs["this"], ref))
            if not all(identical.values()):
                raise RuntimeError(f"builds disagree at B={b} nprobe {nprobe} ({kind} codes): {identical}")
            idx, weight = bag_inputs(a)
            bag_err = bag_check(a, idx, weight)
            runs = {name: launcher(lib, a) for name, lib in libs.items()}
            runs["embedding_bag"] = lambda: torch.nn.functional.embedding_bag(idx, weight, mode="sum")
            iters = 100 if b == 1 else 20
            times: dict[str, list[float]] = {name: [] for name in runs}
            for _ in range(args.rounds):
                for name in ("embedding_bag", *others, "this", "this", *others[::-1], "embedding_bag"):
                    times[name].append(graph_ms(runs[name], iters))
            plain_ms = graph_ms(lambda: adc_scan_reference(*a), 2 if b > 1 else 10)
            mean = {name: sum(t) / len(t) for name, t in times.items()}
            row = {"B": b, "nprobe": nprobe, "lists": lists, "codes": kind, "route": route,
                   "chunks_per_query": nchunk_q, **bound,
                   "identical": identical, "embedding_bag_max_abs_diff": bag_err, "ms": times, "mean_ms": mean,
                   "plain_ms": plain_ms, "this_over_other": mean["this"] / mean[others[0]],
                   "this_over_embedding_bag": mean["this"] / mean["embedding_bag"],
                   "this_over_bound": mean["this"] / bound["bound_ms"]}
            rows.append(row)
            print(f"B={b} nprobe {nprobe} {lists} lists, {kind} codes: NC {bound['nc']}, this {mean['this']:.4f} ms, "
                  + ", ".join(f"{n} {mean[n]:.4f}" for n in (*others, "embedding_bag"))
                  + f"; bound {bound['bound_ms']:.4f} ({bound['bound_by']}); plain {plain_ms:.4f}", flush=True)
            del idx, weight, runs, outs, ref
            torch.cuda.empty_cache()
    print(json.dumps({"card": card_line(), "clock_max_hz": clock, "others": {n: str(r) for n, r in roots.items()},
                      "ptxas": {name: report for name, (_, report) in built.items()}, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

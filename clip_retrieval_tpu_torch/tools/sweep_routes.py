"""Search-batch p50 of every `auto` route of the IVF tiers, by batch size, on one card.

    python3 -m clip_retrieval_tpu_torch.tools.sweep_routes [--rounds 2] [--iters 15]

The port's IVF tiers choose a route per batch: `IVFInt8Index.resolve_union`
(the union sizing: static, exact or device), `IVFPQIndex._budget_route` (a
static chunk budget or per-query budget buckets) and the IVF-PQ choice of
the device scan (kernel K4) or the host C++ scan.  This sweep times each
route forced, at B ∈ {1, 2, 4, 8, 16, 32, 64} (the batches `back` forms;
IVF-PQ also at 128 and 256, the batches an index build scores its recall
with), so that each `auto` rule is set from a measurement on the card:

- IVF-int8 at the smoke's serving shape: 10,000,000 × 768 rows, nlist
  16,384, nprobe 64, generated on the card from a seed as `chip_smoke.py`
  generates them (random unit centroids, multinomial list sizes, rows
  normalize(c + 0.75·g/√d), quantized by `quantize_rows_device`); queries
  from the same distribution; `search(q, 40)` with union static, exact and
  device (each warmed, so the device mode's adaptive cap has settled);
- IVF-PQ at 1,000,000 × 768, nlist 1024, M 64 with skewed lists
  (`ab_adc.served_index(skewed=True)`: exponential list weights, most of
  the static budget's chunks empty, as on the index `clip_index` trains in
  the smoke); at nprobe 32 and 64, `_search_adc(q, 640)` (k 40 times the
  smoke's rerank factor 16: the candidates a served search asks of the
  scan) with the static budget, the budget buckets, and the host scan.

Times are on the host clock around a call that ends in its read-back (the
search batch as `back` runs it), p50 and p90 over `iters` calls per round,
each round running the routes in turn and then in reverse.  For each batch
the routes' ids are compared: the share of ids each route shares with the
first one.  Prints one line per (index, nprobe, B) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .ab_adc import card_line, served_index

BATCHES = (1, 2, 4, 8, 16, 32, 64)  # the micro-batcher's sizes (`back` batches at most 64 queries)
PQ_BATCHES = BATCHES + (128, 256)  # and the larger batches an index build scores its recall with
# the int8 tier at the smoke's serving shape
N_ROWS, DIM, NLIST, NPROBE, K = 10_000_000, 768, 16_384, 64, 40
GEN_BLOCK = 1 << 20
PQ_NPROBES, PQ_K = (32, 64), 40 * 16


def synthetic_ivf_int8(seed: int = 5):
    """The smoke's 10M-row IVF-int8 index, generated on the card and held
    by an `IVFInt8Index` on it; returns (index, a function giving b queries
    of the rows' distribution)."""
    from ..index.ivf_int8 import IVFInt8Index
    from ..ops.int8mm import quantize_rows_device

    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(N_ROWS, np.full(NLIST, 1.0 / NLIST))
    offsets = np.zeros(NLIST + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cent = torch.randn(NLIST, DIM, generator=gen, device="cuda")
    cent /= cent.norm(dim=1, keepdim=True)
    owner = torch.repeat_interleave(torch.arange(NLIST, device="cuda"), torch.from_numpy(sizes).cuda())
    q_vectors = np.empty((N_ROWS, DIM), np.int8)
    scales = np.empty((N_ROWS,), np.float32)
    noise = 0.75 / math.sqrt(DIM)
    for a in range(0, N_ROWS, GEN_BLOCK):
        b = min(a + GEN_BLOCK, N_ROWS)
        x = cent[owner[a:b]] + noise * torch.randn(b - a, DIM, generator=gen, device="cuda")
        qb, sb = quantize_rows_device(x / x.norm(dim=1, keepdim=True))
        q_vectors[a:b] = qb.cpu().numpy()
        scales[a:b] = sb.cpu().numpy()
    ix = IVFInt8Index(DIM, cent.cpu().numpy(), offsets, rng.permutation(N_ROWS).astype(np.int64), q_vectors, scales,
                      nprobe=NPROBE, device="cuda")
    ix._ensure_device()

    def queries(b: int, qseed: int) -> np.ndarray:
        g = torch.Generator(device="cuda")
        g.manual_seed(qseed)
        lists = torch.randint(0, NLIST, (b,), generator=g, device="cuda")
        x = cent[lists] + noise * torch.randn(b, DIM, generator=g, device="cuda")
        return (x / x.norm(dim=1, keepdim=True)).cpu().numpy()

    return ix, queries


def p50_p90(fn, iters: int, warm: int = 2) -> list[float]:
    """Host-clock ms of `iters` calls of fn (each ends in its read-back)."""
    for _ in range(warm):
        fn()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def sweep(name: str, routes: dict, queries, rounds: int, iters: int, extra: dict, batches=BATCHES) -> list[dict]:
    """For each batch size: every route's p50/p90 over `rounds` rounds (the
    routes in turn, then in reverse), and the share of ids each route shares
    with the first route's."""
    rows = []
    for b in batches:
        q = queries(b)
        ids = {r: fn(q)[1] for r, fn in routes.items()}
        first = next(iter(ids))
        shared = {r: float(np.mean([len(set(a.tolist()) & set(f.tolist())) / max(1, (f >= 0).sum())
                                    for a, f in zip(i, ids[first])])) for r, i in ids.items()}
        samples: dict[str, list[float]] = {r: [] for r in routes}
        order = list(routes)
        for rnd in range(rounds):
            for r in order if rnd % 2 == 0 else order[::-1]:
                samples[r] += p50_p90(lambda: routes[r](q), iters)
        stats = {r: {"p50": float(np.percentile(s, 50)), "p90": float(np.percentile(s, 90))}
                 for r, s in samples.items()}
        best = min(stats, key=lambda r: stats[r]["p50"])
        rows.append({"index": name, **extra, "B": b, "ms": stats, "fastest": best, "ids_shared_with_" + first: shared})
        print(f"{name} {extra} B={b}: " + ", ".join(f"{r} p50 {v['p50']:.3f} p90 {v['p90']:.3f}"
                                                    for r, v in stats.items())
              + f" ms; fastest {best}; ids shared with {first}: "
              + ", ".join(f"{r} {v:.4f}" for r, v in shared.items()), flush=True)
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_routes needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    t0 = time.perf_counter()
    pq, pq_q = served_index(skewed=True)
    nprobe_of = {}

    def pq_route(route: str, nprobe: int):
        def run(q):
            if route == "host":
                return pq._search_host(q, PQ_K, nprobe)
            pq._budget_route = lambda _np, _b: route  # this instance only
            try:
                return pq._search_device(q, PQ_K, nprobe)
            finally:
                del pq._budget_route
        return run

    pq_queries = pq_q.cpu().numpy()
    rng = np.random.default_rng(3)
    pq_pool = np.concatenate([pq_queries, rng.standard_normal((max(PQ_BATCHES) - pq_queries.shape[0], DIM))
                              .astype(np.float32)])
    pq_pool /= np.linalg.norm(pq_pool, axis=1, keepdims=True)
    for nprobe in PQ_NPROBES:
        static = pq._static_chunk_budget(nprobe)  # fills the cumulative chunk counts read below
        nprobe_of[nprobe] = {"static_chunks": static,
                             "mean_probed_chunks": int(pq._chunks_desc_cumsum[-1]) * nprobe // pq.nlist,
                             "auto": {b: pq._budget_route(nprobe, b) for b in PQ_BATCHES}}
        routes = {r: pq_route(r, nprobe) for r in ("static", "buckets", "host")}
        rows += sweep("ivfpq_1m_skewed", routes, lambda b: pq_pool[:b], args.rounds, args.iters,
                      {"nprobe": nprobe, "k": PQ_K}, PQ_BATCHES)
    t_pq = time.perf_counter() - t0
    del pq
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ix, queries = synthetic_ivf_int8()
    t_gen = time.perf_counter() - t0

    def int8_route(mode: str):
        def run(q):
            ix.union = mode
            return ix.search(q, K)
        return run

    routes = {m: int8_route(m) for m in ("static", "exact", "device")}
    rows += sweep("ivf_int8_10m", routes, lambda b: queries(b, 100 + b), args.rounds, args.iters,
                  {"nprobe": NPROBE, "k": K})
    print(json.dumps({"card": card_line(), "rounds": args.rounds, "iters": args.iters, "pq_budgets": nprobe_of,
                      "overflow_redispatches": ix.overflow_redispatches, "int8_generate_s": t_gen,
                      "pq_sweep_s": t_pq, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

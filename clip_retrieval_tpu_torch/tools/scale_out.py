"""Scale-out across the visible cards: the dp×tp train step on nccl and the sharded IVF-int8 tier.

    python3 -m clip_retrieval_tpu_torch.tools.scale_out [--steps 5] [--iters 30]

Needs at least two cards (n = every visible one); measures what one card
cannot:

- the train step (`parallel/train.make_train_step`) at ViT-B/32, full width
  and depth, f32, global batch 128 from a seed, `init_clip(seed=0)`, TF32
  off: one process on one card (dp = tp = 1), then n processes on nccl
  (one per card, launched as torchrun would: `RANK`, `WORLD_SIZE`,
  `LOCAL_RANK`, `MASTER_ADDR`=localhost; `set_device(local_rank())`, then
  `init_pod()`) at every (dp, tp) with dp·tp = n that
  the model's heads allow.  Every layout's losses must equal the one-card
  losses to rtol 1e-3, step by step (the same math in another order); ms
  per step (median of the steps after the first, host clock on rank 0 after
  a barrier) and the peak memory of each rank;
- the list-sharded IVF-int8 tier at the smoke's serving shape (10M × 768,
  nlist 16,384, nprobe 64, `sweep_routes.synthetic_ivf_int8`): the
  unsharded tier on one card, n shards all on one card, n shards on n
  cards; search-batch p50 at B=1 and B=32 (`search`, k=40, exact route,
  host clock) and the ids of the two sharded layouts, which must be equal
  (the placement of a shard changes no result).

Prints a line per measurement and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from .sweep_routes import K, p50_p90, synthetic_ivf_int8

MODEL, BATCH, LOSS_RTOL = "ViT-B/32", 128, 1e-3
OUT_DIR = os.path.join("build", "scale_out")


def cards() -> list[str]:
    """Name and power limit of every card, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()


def _batch(cfg):
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, (BATCH, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.vocab_size - 1, (BATCH, cfg.context_length)).astype(np.int32)
    return torch.from_numpy(images), torch.from_numpy(tokens)


def _train_rank(rank: int, dp: int, tp: int, port: int, steps: int, out: str):
    """One rank of a dp×tp world on card `rank`; rank 0 writes the losses and
    step times, every rank its peak memory."""
    import torch.distributed as dist

    from ..models.configs import get_config
    from ..parallel.dist import init_pod, local_rank
    from ..parallel.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    world = dp * tp
    # the launcher's environment, as torchrun sets it, and the README's launch
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.cuda.set_device(local_rank())
    init_pod()
    cfg = get_config(MODEL)
    images, tokens = _batch(cfg)
    b = BATCH // dp
    rows = slice(rank // tp * b, (rank // tp + 1) * b)
    init_fn, step = make_train_step(cfg, dp=dp, tp=tp, device="cuda")
    params, opt = init_fn(0)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        if world > 1:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, images[rows], tokens[rows])
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump({"losses": losses, "ms": ms, "peak_gib": peak}, f)
    if world > 1:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_layouts(n: int, steps: int) -> list[dict]:
    from ..models.configs import get_config

    cfg = get_config(MODEL)
    layouts = [(1, 1)] + [(n // tp, tp) for tp in range(1, n + 1)
                          if n % tp == 0 and cfg.vision_heads % tp == 0 and cfg.text_heads % tp == 0]
    rows, base = [], None
    for dp, tp in layouts:
        out = os.path.join(OUT_DIR, f"dp{dp}_tp{tp}")
        os.makedirs(out, exist_ok=True)
        mp.start_processes(_train_rank, args=(dp, tp, _free_port(), steps, out), nprocs=dp * tp, join=True,
                           start_method="spawn")
        ranks = [json.load(open(f"{out}/rank{r}.json")) for r in range(dp * tp)]
        losses = ranks[0]["losses"]
        for r in ranks:
            if not np.allclose(r["losses"], losses, rtol=LOSS_RTOL):
                raise SystemExit(f"dp={dp} tp={tp}: the ranks disagree on the losses")
        if base is None:
            base = losses
        elif not np.allclose(losses, base, rtol=LOSS_RTOL):
            raise SystemExit(f"dp={dp} tp={tp}: losses {losses} differ from one card's {base}")
        row = {"dp": dp, "tp": tp, "losses": losses, "ms_per_step": float(np.median(ranks[0]["ms"][1:])),
               "first_step_ms": ranks[0]["ms"][0], "peak_gib_by_rank": [r["peak_gib"] for r in ranks]}
        rows.append(row)
        print(f"train {MODEL} f32 b{BATCH} dp={dp} tp={tp}: {row['ms_per_step']:.1f} ms a step (median of steps "
              f"2-{steps}), losses {[round(x, 5) for x in losses]} (= one card's to rtol {LOSS_RTOL}), peak GiB by "
              f"rank {[round(x, 2) for x in row['peak_gib_by_rank']]}", flush=True)
    return rows


def sharded_layouts(n: int, iters: int) -> list[dict]:
    from ..index.sharded_ivf import ShardedIVFInt8Index

    index, queries = synthetic_ivf_int8()
    q = {b: queries(b, 100 + b) for b in (1, 32)}
    rows, ids = [], {}
    tiers = [("unsharded, cuda:0", lambda: index),
             (f"{n} shards on cuda:0", lambda: ShardedIVFInt8Index.from_index(index, devices=["cuda:0"] * n)),
             (f"{n} shards on {n} cards", lambda: ShardedIVFInt8Index.from_index(
                 index, devices=[f"cuda:{i}" for i in range(n)]))]
    for name, make in tiers:
        tier = make()
        tier.union = "exact"
        for b, qb in q.items():
            ids[(name, b)] = tier.search(qb, K)[1]
            ms = p50_p90(lambda: tier.search(qb, K), iters)
            rows.append({"tier": name, "B": b, "p50_ms": float(np.percentile(ms, 50)),
                         "p90_ms": float(np.percentile(ms, 90))})
            print(f"IVF-int8 10M x 768 {name} B={b}: p50 {rows[-1]['p50_ms']:.3f} ms, p90 {rows[-1]['p90_ms']:.3f} "
                  f"(exact route, search k={K}, {iters} batches, host clock)", flush=True)
        if tier is not index:
            del tier
            torch.cuda.empty_cache()
    for b in q:
        if not np.array_equal(ids[(tiers[1][0], b)], ids[(tiers[2][0], b)]):
            raise SystemExit(f"B={b}: the shards on one card and on {n} cards return different ids")
    print(f"ids of the {n} shards on one card and on {n} cards are equal at B=1 and B=32", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    n = torch.cuda.device_count()
    if n < 2:
        print(f"scale_out needs at least two visible cards, found {n}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = cards()
    print("cards:", names, flush=True)
    train = train_layouts(n, args.steps)
    sharded = sharded_layouts(n, args.iters)
    print(json.dumps({"cards": names, "count": n, "train": train, "sharded_ivf_int8": sharded}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

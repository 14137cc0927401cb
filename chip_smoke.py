#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`.  It builds every
CUDA kernel of the port from `clip_retrieval_tpu_torch/csrc/` (one nvcc per
source, in parallel) and the host C++ ADC scanner, checks each kernel against
its plain PyTorch version on the card, and drives the port's paths at
ViT-L/14 (full width, random weights from `init_clip`) and at the other
model families' published widths:

- embedding inference: the `inference` entry point, bf16, batch 256, image
  and text towers; the embeddings are checked, the bf16 kernel path is
  compared with the f32 plain path on the same weights, and the mapper and
  kernel K1 are timed; the same corpus through `inference` at
  EVA02-L/14-336 (rotary q/k, the SwiGLU gate with its LayerNorm: the
  block's two EVA02 kernels, checked and timed at its shapes beforehand);
- the /knn-service query path: a synthetic IVF-int8 index at the repo's 10M
  serving shape (10,000,000 rows of d=768, nlist 16,384, nprobe 64) is
  generated on the card, saved, and served by the `back` entry point
  (`clip_back`, wsgiref on 127.0.0.1) answering embedding, text, image,
  dedup and metadata requests over HTTP, serially and from 32 concurrent
  clients; recall@40 of the served answers is held to an exhaustive scan by
  kernel K3's plain version, and K3, search batches, HTTP latency and QPS
  are timed;
- the unpacked attention entry `ops/attention.py::sdpa` (kernel K2) at the
  image tower's attention shape, timed beside its plain version and
  `F.scaled_dot_product_attention`;
- index build: the `index` entry point (`clip_index`) over a 1,000,000 x 768
  fp16 corpus in the `inference` writer's layout (4 shards + caption
  parquets) with key OPQ64,IVF1024,PQ64,RFlat, nprobe calibrated to
  recall@10 >= 0.95 (kernel K4 scores the calibration and recall searches);
  the built folder is served by the same `back` entry point as a second
  index (64 serial stored-row queries, a text query, 32 concurrent clients;
  each stored row whose own list is among the probed ones comes back first),
  its served recall@40 held to an exact fp16 brute force, K4's device route
  held to the host C++ scan, and search batches timed; K4 is timed (device
  times from CUDA graph replay) beside its plain version and
  `F.embedding_bag` at the B=32 worklists of nprobe served/64/256 and at the
  B=1 worklists of nprobe 1/8/32, where nearly all of its launches fall;
- shard -> combine -> reorder -> serve: pq1m split by id range into 4
  shards sharing its trained prefix and merged by the `index_combiner`
  entry point (arrays and search ids equal pq1m's); an IVF-int8 index over
  the same corpus built as 4 shards against one trained coarse quantizer,
  merged, held to the whole-corpus build, mapped to IVF order
  (`get_old_to_new_mapping`, `search_to_new_ids`) and served by `back` as a
  third index; `parquet_to_arrow` over the corpus's 1M metadata rows;
- the public surface: the package-level API (`clip_inference`,
  `clip_index`, `clip_back`, `clip_filter`, `clip_end2end`, `ClipClient`,
  `Modality`) resolves to the port's objects, and `resize_on_device` over
  32 uint8 480x640 images to 224 on the card is held to the CPU and timed;
- the entry points on ported code: `clip_end2end` over the 512 samples,
  called by its top-level name `clip_retrieval_tpu_torch.clip_end2end`
  (inference, index, an in-process `back` app), `clip_filter` on its index
  (threshold and image-file queries) and on pq1m, and `ClipClient` against
  the running `back`, compared with raw HTTP;
- the other model families: K1 at the ResNet CLIPs' causal text shapes (8,
  10 and 16 heads x 64, S 77); `inference` over the 512 samples at RN50
  bf16 b256 (K1 in the text tower only: 24 launches); RN50 and RN50x64
  (448 px, a 36-block stage, a 4096-d attention pool) bf16 against their f32
  plain path, their image embeddings/s and a `torch.profiler` breakdown of
  RN50's image tower; `convert` of an openai-layout RN50 state dict (random
  convolutions and BatchNorm statistics) validated on the card, its folded
  stem conv held to conv -> BatchNorm and its bf16 embeddings to its f32
  ones; an M-CLIP text tower at XLM-R Large's published width (vocab
  250,002, hidden 1,024, 24 layers, random weights, a 1024 -> 768
  projection) written as a checkpoint directory, loaded by `load_mclip`,
  timed at 1 and 32 texts, run by the mapper with `use_mclip` over the 512
  captions, and answering `/knn-service` text queries with `use_mclip` on
  the merged IVF-int8 index with a direct search's ids (K3, no K1);
- scale-out: two `inference --distribution_strategy pod` ranks (RANK 0/1,
  WORLD_SIZE 2, LOCAL_RANK 0: two hosts of one card each) and two
  `inference.slurm_worker` ranks (SLURM_PROCID 0/1 set by hand, as srun
  would; sbatch is not needed), each its own process, over the 512 samples in 4
  partitions at ViT-L/14 bf16, their partitions held bit for bit to one
  sequential process's and their K1 launches counted by each process; the
  list-sharded IVF-int8 tier built from the 10M index with its 4 shards all
  on this card (`devices=["cuda:0"] * 4`: the cost of the shard logic, not a
  speed-up), held on the exact, device and static routes at B=1 and B=32 (K3
  once per shard per batch, scores equal to the int8 products, recall@40 at
  least the unsharded tier's on every query, the unsharded ids at nprobe =
  nlist), timed beside the unsharded tier, and served by `back` with
  `sharded_index`; the flat_int8 tier over the same int8 rows on 4 shards
  and on one device (equal ids); and the dp×tp train step at ViT-B/32 (full
  width and depth, f32, batch 128) as a world of one nccl rank, 5 steps, its
  first loss held to the plain forward on the CPU.

Phases, each of which stops the script with a non-zero exit when it fails:
device, build, K1 vs plain, K3 vs plain, K2 vs plain, K4 vs plain, block
fused vs plain (the dense epilogue and the LayerNorm of `ops/block_fused.py`
held to the eager chain and timed beside it at the ViT-L/14 and SigLIP
So400m/384 towers' shapes), EVA02 fused vs plain (the rotary epilogue and the
SwiGLU gate at EVA02-L/14-336's shapes), main path, EVA02 main path (the
same corpus through `inference` at EVA02-L/14-336), tower parity, times, sdpa path, K1 at the ResNet text shapes, RN50
main path, RN tower parity, convert, index build, combine IVF-int8 build,
index, served path, recall, query times, IVF-PQ checks, combine IVF-PQ,
combine IVF-int8, arrow, surface, end2end, filter, client, mclip, pod and
slurm_worker ranks, sharded IVF-int8, sharded flat_int8, train.  Kernel launch
counts are set to 0 just before each path and read just after it.  The line before the
last is a JSON object describing each kernel; the last line is `{"ok":
true, "device": {...}}`.  Without a CUDA device, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import base64
import http.client
import importlib.util
import io
import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np

BATCH = 256
SAMPLES = 512
MODEL = "ViT-L/14"
# (heads, dh, S, causal): every attention geometry of the supported towers
# (the ResNet CLIPs' text towers: 8 heads for RN50/RN101, 10 for RN50x4, 12 for RN50x16, 16 for RN50x64)
GEOMETRIES = [(12, 64, 50, False), (16, 64, 257, False), (16, 80, 257, False), (16, 88, 257, False),
              (16, 64, 577, False), (12, 64, 77, True), (8, 64, 77, True), (10, 64, 77, True), (16, 64, 77, True)]
# ragged edges of the 16-row / 16-key tiling, B=3: (heads, dh, S); dh 20 takes the non-vectorised route
EDGE_GEOMETRIES = ([(12, 64, s) for s in (1, 16, 17, 65, 129)] + [(8, 64, s) for s in (1, 17, 77, 129)]
                   + [(16, 88, 17), (16, 88, 129), (3, 20, 65)])
# K2 with Sq != Sk at the edges: (heads, dh, Sq, Sk)
EDGE_SQ_SK = [(12, 64, 1, 257), (12, 64, 257, 1), (12, 64, 77, 257)]
BF16_MAX_ABS, BF16_MIN_COS, F32_MAX_ABS = 2e-2, 0.9999, 1e-4
TOWER_MIN_COS = 0.999  # tests/test_models/test_clip_parity.py:101-102
WORK_DIR = os.path.join("build", "chip_smoke")
# the query path: the 10M serving shape of clip_retrieval_tpu/index/ivf_int8.py at ViT-L/14's width
N_ROWS, DIM, NLIST, NPROBE = 10_000_000, 768, 16_384, 64
INDEX_NAME = "smoke10m"
TOPK = 40  # num_images of every /knn-service request here
N_QUERIES = 64  # stored rows queried with their f32 originals
CLIENTS = 32
MIN_RECALL = 0.95
GEN_BLOCK = 1 << 20  # rows generated per block on the card
# the index-build path: `clip_index` over a corpus at ViT-L/14's width, not reduced
PQ_ROWS, PQ_SHARDS, PQ_CENTRES = 1_000_000, 4, 4096
PQ_KEY = "OPQ64,IVF1024,PQ64,RFlat"
PQ_INDEX = "pq1m"
PQ_MIN_RECALL, PQ_MIN_OVERLAP, PQ_SCORE_TOL = 0.90, 0.99, 1e-4
K4_MS, K4_BS = (8, 16, 64, 96, 192, 256), (1, 3, 32, 128)
# slice 4: shard builds merged by `index_combiner`; the IVF-int8 index built over the pq1m corpus, served third
COMBINE_SHARDS, INT8_NLIST, INT8_INDEX = 4, 1024, "int8combined1m"
# slice 5: the ResNet towers (RN50x64 is the widest published one: 448 px, a 36-block stage, a 4096-d
# attention pool) and the M-CLIP text tower at XLM-R Large's published width, as multilingual_clip's
# M-CLIP/XLM-Roberta-Large-Vit-L-14 uses it, projected into ViT-L/14's 768-d space
RN_MODEL, RN_WIDE, RN_WIDE_BATCH = "RN50", "RN50x64", 64
RN_BN3_SCALE = 0.25  # the residual branches' folded bn3 weight in the parity check (see phase_rn_towers)
MCLIP_CONFIG = {"model_type": "xlm-roberta", "architectures": ["XLMRobertaModel"], "vocab_size": 250002,
                "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16, "intermediate_size": 4096,
                "max_position_embeddings": 514, "type_vocab_size": 1, "pad_token_id": 1, "bos_token_id": 0,
                "eos_token_id": 2, "layer_norm_eps": 1e-5, "hidden_act": "gelu"}
MCLIP_QUERIES = ["une photo d'un chat sur un canapé", "ein Foto von einem Hund im Schnee",
                 "a photo of sample number 7, seed 42", "una foto de la playa al atardecer", "猫の写真"]
# slice 6: the sharded tiers' shards (all on the one card: cuda:0 four times), the rank runs' partitions, and the
# train step's model and batch (ViT-B/32 at full width and depth)
SHARDS, RANK_PARTITIONS, TRAIN_MODEL, TRAIN_BATCH = 4, 4, "ViT-B/32", 128
# slice 7: the package-level API (name -> module, attribute) and the batched resize on the card
SURFACE_API = {"clip_inference": ("inference.main", "main"), "clip_index": ("index.build", "clip_index"),
               "clip_back": ("back.app", "clip_back"), "clip_filter": ("filter", "clip_filter"),
               "clip_end2end": ("end2end", "clip_end2end"), "ClipClient": ("client", "ClipClient"),
               "Modality": ("client", "Modality")}
RESIZE_BATCH, RESIZE_FROM, RESIZE_TO, RESIZE_ATOL = 32, (480, 640), 224, 2e-5
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, dense bf16 FLOP/s, SMs
HBM_BPS, BF16_FLOPS, SMS = 3.35e12, 989e12, 132
# the block's fused passes (`ops/block_fused.py`) at the benchmark cells' towers, batch 256:
# tower -> (rows, width, MLP width, activation, LayerNorm eps)
FUSED_TOWERS = {"vit-l-14 image": (BATCH * 257, 1024, 4096, "quick_gelu", 1e-5),
                "vit-l-14 text": (BATCH * 77, 768, 3072, "quick_gelu", 1e-5),
                "siglip image": (BATCH * 729, 1152, 4304, "gelu_tanh", 1e-6),
                "siglip text": (BATCH * 64, 1152, 4304, "gelu_tanh", 1e-6)}
FUSED_MIN_EQUAL = 0.999  # share of bf16 elements equal to the eager chain's where an activation runs
# the one-kernel dense (`block_fused.dense_gemm`) at SigLIP So400m/384's image fc1, batch 256: (M, K, N, act);
# against its plain version and the split route at least this share of bf16 elements equal (the products sum
# in other orders)
GEMM_SHAPE, GEMM_MIN_EQUAL = (BATCH * 729, 1152, 4304, "gelu_tanh"), 0.99
# EVA02-L/14-336 (the third cell's model) at batch 256: its image tower's rows, width, head dim, the rotary
# reference grid, the SwiGLU hidden and that hidden padded (`models/clip.py::GLU_ALIGN`)
EVA_MODEL = "EVA02-L-14-336"
EVA_ROWS, EVA_SEQ, EVA_WIDTH, EVA_HEAD_DIM, EVA_HIDDEN, EVA_PADDED = BATCH * 577, 577, 1024, 64, 2730, 2736


class PhaseError(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def min_row_cos(a, b) -> float:
    import torch

    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min().item()


def check_attention(name: str, got, ref, dh: int, where: str) -> float:
    """An attention kernel's output against its plain version's (f32, same
    inputs): finite, and bf16 max abs ≤ 2e-2 with min row cosine ≥ 0.9999,
    or f32 max abs ≤ 1e-4.  Returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    cos = min_row_cos(got.reshape(-1, dh), ref.reshape(-1, dh))
    finite = bool(torch.isfinite(got).all())
    print(f"  {name} {where}: max_abs={err:.3e} min_cos={cos:.7f} finite={finite}")
    check(finite, f"{name} non-finite output at {where}")
    if got.dtype == torch.bfloat16:
        check(err <= BF16_MAX_ABS and cos >= BF16_MIN_COS, f"{name} bf16 off at {where}")
    else:
        check(err <= F32_MAX_ABS, f"{name} f32 off at {where}")
    return err


def check_k1(flash, q, k, v, heads: int, causal: bool) -> float:
    """One K1 call against its plain version; returns the max abs error."""
    b, s, w = q.shape
    got = flash.flash_attention_packed(q, k, v, heads, causal=causal)
    ref = flash.flash_attention_packed_reference(q.float(), k.float(), v.float(), heads, causal=causal)
    where = f"{str(q.dtype).split('.')[-1]} B={b} heads={heads} dh={w // heads} S={s} causal={causal}"
    return check_attention("K1", got, ref, w // heads, where)


def phase_kernels(flash) -> float:
    """K1 against its plain version on the card at every tower geometry,
    B=4, and at the tiling's ragged edges (EDGE_GEOMETRIES, causal and not),
    B=3; returns the worst bf16 max abs error."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [(4, *geo) for geo in GEOMETRIES]
    cases += [(3, heads, dh, s, causal) for heads, dh, s in EDGE_GEOMETRIES for causal in (False, True)]
    worst_bf16 = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for b, heads, dh, s, causal in cases:
            q, k, v = (torch.randn(b, s, heads * dh, generator=gen, device="cuda").to(dtype) for _ in range(3))
            err = check_k1(flash, q, k, v, heads, causal)
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
    return worst_bf16


def check_k2(flash, q, k, v, causal: bool) -> float:
    """One K2 call against its plain version; returns the max abs error."""
    b, h, sq, dh = q.shape
    got = flash.flash_attention(q, k, v, causal=causal)
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    where = f"{str(q.dtype).split('.')[-1]} B={b} H={h} Sq={sq} Sk={k.shape[2]} dh={dh} causal={causal}"
    return check_attention("K2", got, ref, dh, where)


def phase_k2(flash) -> float:
    """K2 against its plain version on the card at every tower geometry in the
    (B, H, S, dh) layout, bf16 and f32, causal and not, plus Sq != Sk, B=4;
    and at the tiling's ragged edges (EDGE_GEOMETRIES and EDGE_SQ_SK), B=3.
    Returns the worst bf16 max abs error."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    shapes = [(4, heads, dh, s, s) for heads, dh, s, _ in GEOMETRIES] + [(4, 16, 64, 257, 77), (4, 12, 64, 50, 300)]
    shapes += [(3, heads, dh, s, s) for heads, dh, s in EDGE_GEOMETRIES] + [(3, *geo) for geo in EDGE_SQ_SK]
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for dtype in worst:
        for b, heads, dh, sq, sk in shapes:
            for causal in (False, True):
                q = torch.randn(b, heads, sq, dh, generator=gen, device="cuda").to(dtype)
                k, v = (torch.randn(b, heads, sk, dh, generator=gen, device="cuda").to(dtype) for _ in range(2))
                worst[dtype] = max(worst[dtype], check_k2(flash, q, k, v, causal))
    print(f"  K2 vs plain: {2 * len(shapes)} shapes x bf16/f32 (every tower geometry causal and not, Sq != Sk "
          f"257/77 and 50/300, ragged edges S 1/16/17/65/129 and Sq/Sk 1/257, 257/1, 77/257): bf16 max abs "
          f"{worst[torch.bfloat16]:.3e} (bar {BF16_MAX_ABS}), f32 max abs {worst[torch.float32]:.3e} "
          f"(bar {F32_MAX_ABS})")
    return worst[torch.bfloat16]


def check_k4(adc, args) -> float:
    """K4 against its plain version on the same inputs: bit-identical, equal
    -inf sets.  Returns the max abs difference of the finite entries (0.0)."""
    import torch

    got = adc.adc_scan(*args)
    ref = adc.adc_scan_reference(*args)
    torch.cuda.synchronize()
    where = f"M={args[0].shape[1]} B={args[1].shape[0]} NC={args[2].shape[0]}"
    check(got.shape == ref.shape, f"K4 shape {tuple(got.shape)} vs {tuple(ref.shape)} at {where}")
    check(torch.equal(torch.isneginf(got), torch.isneginf(ref)), f"K4 -inf set differs at {where}")
    fin = torch.isfinite(ref)
    err = (got[fin] - ref[fin]).abs().max().item() if bool(fin.any()) else 0.0
    check(torch.equal(got, ref), f"K4 not bit-identical to its plain version at {where} (max abs {err:.3e})")
    return err


def k4_edges(gen, nblocks: int) -> list:
    """The edges of K4's work split, as (label, B, blocks, nvalid, owner):
    NC = 1; NC below the SM count with owner runs that start inside a span;
    one owner's run split across many blocks; spans that begin mid-owner
    (7 owners over 1001 chunks); nvalid 0 everywhere; the served layout (each
    owner's budget of valid chunks followed by an empty tail)."""
    import torch

    c = 128
    i32 = dict(dtype=torch.int32, device="cuda")

    def rand_blocks(nc):
        return torch.randint(0, nblocks, (nc,), generator=gen, **i32)

    def rand_valid(nc):
        return torch.randint(0, c + 1, (nc,), generator=gen, **i32)

    def by_owner(nc, b):
        return (torch.arange(nc, device="cuda") * b // nc).int()

    served_valid = torch.zeros(4, 512, **i32)
    for q, k in enumerate((300, 1, 511, 0)):  # valid chunks of each owner's 512, then the empty tail
        served_valid[q, :k] = torch.randint(1, c + 1, (k,), generator=gen, **i32)
    return [
        ("NC=1", 1, rand_blocks(1), torch.tensor([77], **i32), torch.zeros(1, **i32)),
        ("NC=100 < SMs", 3, rand_blocks(100), rand_valid(100), by_owner(100, 3)),
        ("one owner over 3000 chunks", 1, rand_blocks(3000), rand_valid(3000), torch.zeros(3000, **i32)),
        ("7 owners over 1001 chunks", 7, rand_blocks(1001), rand_valid(1001), by_owner(1001, 7)),
        ("nvalid 0 everywhere", 3, rand_blocks(777), torch.zeros(777, **i32), by_owner(777, 3)),
        ("served layout, empty tails", 4, rand_blocks(2048), served_valid.reshape(-1), by_owner(2048, 4)),
    ]


def phase_k4(adc) -> float:
    """K4 against its plain version at M in K4_MS x B in K4_BS, C = 128: a
    short worklist with nvalid 0, partial and full chunks, repeated blocks
    and owners out of order, and a long one ordered by owner (the served
    layout); at every M the edges of the work split (`k4_edges`) and, where
    M allows, codes at 4- and 1-byte alignment (the kernel's narrower load
    routes); out-of-range blocks and owners give NaN rows and leave the
    other chunks as the plain version has them."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    nblocks, c, worst, n = 16, adc.CHUNK, 0.0, 0
    i32 = dict(dtype=torch.int32, device="cuda")
    for m in K4_MS:
        codes = torch.randint(0, 256, (nblocks * c, m), generator=gen, device="cuda", dtype=torch.uint8)
        for b in K4_BS:
            lut = torch.randn(b, m, 256, generator=gen, device="cuda")
            short = (torch.tensor([0, 3, 3, nblocks - 1, 1, 0, 2, 5, 5, 6], **i32),
                     torch.tensor([c, 0, 77, c, 1, c, 50, c, 0, c - 1], **i32),
                     torch.tensor([0, 0, 1, 1, 2, 2, 0, 3, 1, 0], **i32) % b)
            nc = 5000
            long = (torch.randint(0, nblocks, (nc,), generator=gen, **i32),
                    torch.randint(0, c + 1, (nc,), generator=gen, **i32),
                    (torch.arange(nc, device="cuda") * b // nc).int())
            for blocks, nvalid, owner in (short, long):
                coarse = torch.randn(blocks.shape[0], generator=gen, device="cuda")
                worst = max(worst, check_k4(adc, (codes, lut, blocks, nvalid, owner, coarse)))
                n += 1
        edges = k4_edges(gen, nblocks)
        for _, b, blocks, nvalid, owner in edges:
            lut = torch.randn(b, m, 256, generator=gen, device="cuda")
            coarse = torch.randn(blocks.shape[0], generator=gen, device="cuda")
            worst = max(worst, check_k4(adc, (codes, lut, blocks, nvalid, owner, coarse)))
            n += 1
        # the same codes at 4- and 1-byte alignment: a view into a larger buffer
        _, b, blocks, nvalid, owner = edges[3]
        lut = torch.randn(b, m, 256, generator=gen, device="cuda")
        coarse = torch.randn(blocks.shape[0], generator=gen, device="cuda")
        for off in (4, 1):
            buf = torch.empty(codes.numel() + 16, dtype=torch.uint8, device="cuda")
            shifted = buf[off : off + codes.numel()].view(codes.shape)
            shifted.copy_(codes)
            check(shifted.data_ptr() % 16 == off, f"codes view at offset {shifted.data_ptr() % 16}")
            worst = max(worst, check_k4(adc, (shifted, lut, blocks, nvalid, owner, coarse)))
            n += 1
        # out-of-range blocks and owners: NaN rows, the other chunks as the plain version gives them
        blocks_bad, owner_bad = blocks.clone(), owner.clone()
        blocks_bad[5], owner_bad[500], blocks_bad[900] = nblocks, b, -1
        got = adc.adc_scan(codes, lut, blocks_bad, nvalid, owner_bad, coarse)
        ref = adc.adc_scan_reference(codes, lut, blocks, nvalid, owner, coarse)
        torch.cuda.synchronize()
        bad = torch.zeros(blocks.shape[0], dtype=torch.bool, device="cuda")
        bad[[5, 500, 900]] = True
        check(bool(torch.isnan(got[bad]).all()), f"K4 out-of-range chunks not NaN at M={m}")
        check(torch.equal(got[~bad], ref[~bad]), f"K4 chunks beside out-of-range ones differ at M={m}")
        n += 1
    print(f"  K4 vs plain: {n} worklists (M {'/'.join(map(str, K4_MS))} x B {'/'.join(map(str, K4_BS))} x "
          f"(10 chunks: nvalid 0/partial/full, repeated blocks; 5000 chunks ordered by owner); at every M: "
          f"{'; '.join(e[0] for e in edges)}; codes at 4- and 1-byte alignment; out-of-range blocks/owners NaN) "
          f"bit-identical; max abs err {worst}")
    return worst


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), in f32."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).to(torch.int32))


def time_pair(kern, plain) -> tuple[float, float]:
    """ms per call of a kernel and of its plain version, in turns (plain,
    kernel, kernel, plain) after a warm-up."""
    for fn in (kern, plain):
        fn()
    times: dict[str, list[float]] = {"kern": [], "plain": []}
    for name, fn in (("plain", plain), ("kern", kern), ("kern", kern), ("plain", plain)):
        times[name].append(cuda_ms(fn, 10))
    return float(np.mean(times["kern"])), float(np.mean(times["plain"]))


def phase_block_fused(block_fused, gpu: str) -> dict:
    """The block's two fused kernels against their plain versions (the eager
    chain, run on the card) at each tower of the two benchmark cells, bf16
    batch 256: every epilogue of a block (q/k/v: bias and cast; wo and w_out:
    the residual besides; w_in: the activation) and both LayerNorms.  Bars:
    without an activation bit for bit; with one, at most one bf16 ulp and
    equal on ≥ 99.9 % of the elements; LayerNorm within one bf16 ulp, or
    1e-6 where an output near 0 meets f32 statistics summed in another
    order.  Each is timed beside the eager chain and its byte bound (every
    byte read and written once at the HBM rate).  Returns the kernels line's
    numbers: per tower, one block's epilogues and LayerNorms summed."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    bf16 = torch.bfloat16
    out = {"epilogue": {"max_abs_err": 0.0, "towers": {}}, "layernorm": {"max_abs_err": 0.0, "towers": {}}}
    for tower, (rows, w, mlp, act, eps) in FUSED_TOWERS.items():
        x = torch.randn(rows, w, generator=gen, device="cuda").to(bf16)
        cases = [("qkv", w, None, None)] * 3 + [("wo", w, None, x), ("w_in", mlp, act, None), ("w_out", w, None, x)]
        sums = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        timed: dict[str, tuple[float, float]] = {}
        for name, n, a, res in cases:
            acc = torch.randn(rows, n, generator=gen, device="cuda") * 2.5
            bias = torch.randn(n, generator=gen, device="cuda") * 0.5
            kern = lambda: block_fused.dense_epilogue(acc, bias, act=a, residual=res, dtype=bf16)  # noqa: E731
            plain = lambda: block_fused.dense_epilogue_reference(acc, bias, a, res, bf16)  # noqa: E731
            got, want = kern(), plain()
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            where = f"{tower} {name} ({rows}, {n}) act={a} residual={res is not None}"
            if a is None:
                check(torch.equal(got, want), f"dense_epilogue differs from the eager chain at {where}")
            else:
                check(bool((diff <= bf16_ulp(want)).all()), f"dense_epilogue more than one ulp off at {where}")
                equal = (diff == 0).float().mean().item()
                check(equal >= FUSED_MIN_EQUAL, f"dense_epilogue equal on only {equal:.5f} at {where}")
            out["epilogue"]["max_abs_err"] = max(out["epilogue"]["max_abs_err"], diff.max().item())
            if name not in timed:
                timed[name] = time_pair(kern, plain)
            ms, plain_ms = timed[name]
            bound = 1e3 * (rows * n * (4 + 2 + (2 if res is not None else 0)) + 4 * n) / HBM_BPS
            sums["ms"] += ms
            sums["plain_ms"] += plain_ms
            sums["bound_ms"] += bound
            print(f"  [{gpu}] dense_epilogue {where}: {ms:.4f} ms/call, eager chain {plain_ms:.4f}, bound "
                  f"{bound:.4f} (bytes); max abs vs eager {diff.max().item():.3e}")
            del acc, got, want, diff
        out["epilogue"]["towers"][tower] = sums
        scale = torch.randn(w, generator=gen, device="cuda") * 0.2 + 1
        shift = torch.randn(w, generator=gen, device="cuda") * 0.1
        kern = lambda: block_fused.layernorm(x, scale, shift, eps)  # noqa: E731
        plain = lambda: block_fused.layernorm_reference(x, scale, shift, eps)  # noqa: E731
        got, want = kern(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        check(bool(((diff <= bf16_ulp(want)) | (diff <= 1e-6)).all()),
              f"layernorm more than one ulp off at {tower} ({rows}, {w}) eps={eps}")
        out["layernorm"]["max_abs_err"] = max(out["layernorm"]["max_abs_err"], diff.max().item())
        ms, plain_ms = time_pair(kern, plain)
        bound = 1e3 * (rows * w * 4 + 8 * w) / HBM_BPS
        print(f"  [{gpu}] layernorm {tower} ({rows}, {w}) eps={eps}: {ms:.4f} ms/call, eager chain "
              f"{plain_ms:.4f}, bound {bound:.4f} (bytes); max abs vs eager {diff.max().item():.3e}")
        out["layernorm"]["towers"][tower] = {"ms": 2 * ms, "plain_ms": 2 * plain_ms, "bound_ms": 2 * bound}
        del x, got, want, diff
        torch.cuda.empty_cache()
    for key, what in (("epilogue", "6 epilogues"), ("layernorm", "2 LayerNorms")):
        print(f"  [{gpu}] a block's {what}, ms (kernel / eager chain / bound): " + "; ".join(
            f"{t} {v['ms']:.4f} / {v['plain_ms']:.4f} / {v['bound_ms']:.4f}"
            for t, v in out[key]["towers"].items()))
    return out


def phase_dense_gemm(block_fused, gpu: str) -> dict:
    """The one-kernel dense (`block_fused.dense_gemm`, `csrc/dense_gemm.cu`)
    at SigLIP So400m/384's image fc1 (`GEMM_SHAPE`, bias and tanh GELU), bf16:
    against the plain version (the f32 product with TF32 off, then the
    eager epilogue of torch ops, which shares no code with the kernel) and
    against the split route (cuBLAS's f32 product and `dense_epilogue`),
    each within the bound tests/test_torch_dense_gemm.py states and equal on
    ≥ `GEMM_MIN_EQUAL` of the elements (the products sum in other orders),
    and its f32 product against an f64 product on 2048 rows within K·2⁻²³ of
    Σ|x||w|.  Timed beside the split route (the library yardstick),
    `torch.mm` alone, the plain version and its bound (the FLOPs at 989
    TFLOP/s, or x, w and the output moved once, whichever is longer).
    Returns the kernels line's numbers; `max_abs_err` is the plain
    version's."""
    import torch

    m, k, n, act = GEMM_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    bf16 = torch.bfloat16
    x = (torch.randn(m, k, generator=gen, device="cuda") * 0.5).to(bf16)
    w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(bf16)
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    kern = lambda: block_fused.dense_gemm(x, w, bias, act=act)  # noqa: E731
    split = lambda: block_fused.dense_epilogue(torch.mm(x, w, out_dtype=torch.float32), bias, act=act,  # noqa: E731
                                               dtype=bf16)
    plain = lambda: block_fused.dense_gemm_reference(x, w, bias, act, None, bf16)  # noqa: E731
    where = f"({m}, {k}) @ ({k}, {n}) act={act}"
    got = kern()
    mag = torch.mm(x.abs(), w.abs(), out_dtype=torch.float32)
    t_ulp = bf16_ulp(torch.mm(x, w, out_dtype=torch.float32) + bias)
    errs, equal = {}, {}
    for name, against in (("plain version", plain), ("split route", split)):
        want = against()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        check(bool((diff <= 1.2 * (2 * k * 2.0 ** -23 * mag + t_ulp) + 2 * bf16_ulp(want)).all()),
              f"dense_gemm further off the {name} than the sums' orders explain at {where}")
        equal[name] = (diff == 0).float().mean().item()
        check(equal[name] >= GEMM_MIN_EQUAL, f"dense_gemm equal to the {name} on only {equal[name]:.5f} at {where}")
        errs[name] = diff.max().item()
        del want, diff
    err = errs["plain version"]
    del got, mag, t_ulp
    rows = torch.arange(0, m, m // 2048, device="cuda")
    prod = block_fused.dense_gemm(x, w, dtype=torch.float32)[rows].double()
    ref, mag = x[rows].double() @ w.double(), x[rows].double().abs() @ w.double().abs()
    rel = ((prod - ref).abs() / mag).max().item()
    check(rel <= k * 2.0 ** -23, f"dense_gemm's f32 product is {rel:.3e} of Σ|x||w| off an f64 product at {where}")
    del prod, ref, mag
    torch.cuda.empty_cache()
    ms, split_ms = time_pair(kern, split)
    mm_ms, plain_ms = cuda_ms(lambda: torch.mm(x, w), 10), cuda_ms(plain, 3)
    bound = 1e3 * max(2 * m * n * k / BF16_FLOPS, 2 * (m * k + k * n + m * n) / HBM_BPS)
    print(f"  [{gpu}] dense_gemm {where}: {ms:.4f} ms/call, split route (cuBLAS f32 product + dense_epilogue) "
          f"{split_ms:.4f}, torch.mm alone {mm_ms:.4f}, plain {plain_ms:.4f}, bound {bound:.4f} (FLOPs); max abs vs "
          f"plain {err:.3e} (equal share {equal['plain version']:.5f}), vs split {errs['split route']:.3e} (equal "
          f"share {equal['split route']:.5f}); f32 product vs f64 {rel:.3e} of Σ|x||w|")
    del x, w
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "library_ms": split_ms,
            "mm_ms": mm_ms}


def phase_eva_fused(block_fused, gpu: str) -> dict:
    """EVA02's two fused passes against their plain versions (run on the
    card) at the cell's shapes, bf16 batch 256: the rotary epilogue of q and
    of k (256, 577, 1024), the class row unturned, and the SwiGLU gate with
    its LayerNorm ((256·577, 2·2736) → (256·577, 2736), the hidden 2730, pad
    columns zero).  Bars: one bf16 ulp, or 1e-6 (rotary) and 1e-5 (gate,
    statistics summed in another order) where an output is near 0.  Each is
    timed beside its plain version (the eager chain of torch ops) and its
    byte bound.  Returns, for each, one image block's calls summed (2 rotary
    calls, 1 gate)."""
    import torch

    from clip_retrieval_tpu_torch.models.clip import rope_table

    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    bf16 = torch.bfloat16
    out = {}
    acc = torch.randn(BATCH, EVA_SEQ, EVA_WIDTH, generator=gen, device="cuda") * 2
    bias = torch.randn(EVA_WIDTH, generator=gen, device="cuda") * 0.5
    table = rope_table(24, 16, EVA_HEAD_DIM).cuda()
    kern = lambda: block_fused.rope_epilogue(acc, bias, table, prefix=1, dtype=bf16)  # noqa: E731
    plain = lambda: block_fused.rope_reference(acc, bias, table, 1, bf16)  # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    check(bool(((diff <= bf16_ulp(want)) | (diff <= 1e-6)).all()), "rope_epilogue more than one ulp off")
    check(torch.equal(got[:, 0], (acc[:, 0] + bias).to(bf16)), "rope_epilogue turned the class row")
    ms, plain_ms = time_pair(kern, plain)
    bound = 1e3 * (EVA_ROWS * EVA_WIDTH * 6 + 4 * EVA_WIDTH + 4 * 576 * EVA_HEAD_DIM) / HBM_BPS
    print(f"  [{gpu}] rope_epilogue ({BATCH}, {EVA_SEQ}, {EVA_WIDTH}) dh={EVA_HEAD_DIM}: {ms:.4f} ms/call, eager "
          f"chain {plain_ms:.4f}, bound {bound:.4f} (bytes); max abs vs plain {diff.max().item():.3e}")
    out["rope"] = {"ms": 2 * ms, "plain_ms": 2 * plain_ms, "bound_ms": 2 * bound, "max_abs_err": diff.max().item()}
    del acc, got, want, diff
    acc = torch.randn(EVA_ROWS, 2 * EVA_PADDED, generator=gen, device="cuda") * 1.5
    bias = torch.randn(2 * EVA_PADDED, generator=gen, device="cuda") * 0.3
    scale = torch.randn(EVA_HIDDEN, generator=gen, device="cuda") * 0.2 + 1
    shift = torch.randn(EVA_HIDDEN, generator=gen, device="cuda") * 0.1
    kern = lambda: block_fused.glu_layernorm(acc, bias, scale, shift, 1e-6, dtype=bf16)  # noqa: E731
    plain = lambda: block_fused.glu_layernorm_reference(acc, bias, scale, shift, 1e-6, bf16)  # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    check(bool(((diff <= bf16_ulp(want)) | (diff <= 1e-5)).all()), "glu_layernorm more than one ulp off")
    check(not got[:, EVA_HIDDEN:].any(), "glu_layernorm wrote non-zero pad columns")
    ms, plain_ms = time_pair(kern, plain)
    bound = 1e3 * (EVA_ROWS * EVA_HIDDEN * 10 + 16 * EVA_HIDDEN) / HBM_BPS
    print(f"  [{gpu}] glu_layernorm ({EVA_ROWS}, {EVA_HIDDEN} of {EVA_PADDED}): {ms:.4f} ms/call, eager chain "
          f"{plain_ms:.4f}, bound {bound:.4f} (bytes); max abs vs plain {diff.max().item():.3e}")
    out["glu"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "max_abs_err": diff.max().item()}
    del acc, got, want, diff
    torch.cuda.empty_cache()
    return out


def write_corpus(folder: str):
    from PIL import Image

    os.makedirs(folder)
    rng = np.random.default_rng(0)
    for i in range(SAMPLES):
        h, w = (240, 320) if i % 2 else (300, 260)  # both orientations exercise resize + crop
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(f"{folder}/{i:04d}.jpg", quality=90)
        with open(f"{folder}/{i:04d}.txt", "w") as f:
            f.write(f"a photo of sample number {i}, seed {int(rng.integers(1 << 20))}")


def phase_main_path(kernels: dict, gpu: str, model: str = MODEL) -> dict:
    """The `inference` entry point over 512 JPEG+caption samples at `model`
    (ViT-L/14, or EVA02-L/14-336 on the same corpus, written by the first)
    bf16 b256, random weights; returns the launch counts of that run (K1 and
    the block's fused kernels are on this path: at EVA02, the rotary
    epilogue and the SwiGLU gate too)."""
    from clip_retrieval_tpu_torch.inference.main import main as clip_inference
    from clip_retrieval_tpu_torch.models.configs import get_config

    cfg = get_config(model)
    corpus, out = f"{WORK_DIR}/corpus", f"{WORK_DIR}/out-{model.replace('/', '-')}"
    if model == MODEL:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
        check(importlib.util.find_spec("PIL") is not None, "PIL is needed to write and decode the JPEG corpus")
        for mod in ("pandas", "pyarrow"):
            check(importlib.util.find_spec(mod) is not None, f"{mod} is needed to write the parquet metadata")
        write_corpus(corpus)
    zero_counts(kernels)
    k1 = kernels["k1"]
    k1.launches_by_route = dict.fromkeys(k1.launches_by_route, 0)
    t0 = time.perf_counter()
    clip_inference(
        input_dataset=corpus, output_folder=out, batch_size=BATCH, num_prepro_workers=8, clip_model=model,
        device="cuda",
    )
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    launches = counts["k1"]
    by_route = dict(k1.launches_by_route)
    print(f"  [{gpu}] main path {model} wall {wall:.2f} s on the host clock, 2 batches, including model init and "
          f"JPEG decode; K1 launches {launches}, by route {by_route}; fused {counts}")
    for sub, name in (("img_emb", "img_emb_0.npy"), ("text_emb", "text_emb_0.npy")):
        emb = np.load(f"{out}/{sub}/{name}")
        norms = np.linalg.norm(emb.astype(np.float32), axis=-1)
        print(f"  {sub}: shape={emb.shape} dtype={emb.dtype} norm range [{norms.min():.5f}, {norms.max():.5f}]")
        check(emb.shape == (SAMPLES, cfg.embed_dim) and emb.dtype == np.float16,
              f"{sub} has shape {emb.shape} {emb.dtype}")
        check(bool(np.isfinite(emb).all()), f"{sub} has non-finite values")
        check(bool(np.all(np.abs(norms - 1) <= 1e-2)), f"{sub} norms leave 1 ± 1e-2")
    import pandas as pd

    meta = pd.read_parquet(f"{out}/metadata/metadata_0.parquet")
    check(len(meta) == SAMPLES and list(meta.columns) == ["image_path", "caption"], "bad parquet metadata")
    with open(f"{out}/stats/0.json") as f:
        stats = json.load(f)
    check(stats.get("sample_count") == SAMPLES, f"stats count {stats.get('sample_count')}")
    layers, vl = cfg.vision_layers + cfg.text_layers, cfg.vision_layers
    expected = 2 * layers  # 2 batches x (vision + text layers)
    check(launches == expected, f"K1 launched {launches} times on the main path, expected {expected}")
    check(by_route == {"wgmma": expected, "mma_sync": 0, "f32": 0}, f"K1's routes on the main path: {by_route}")
    check(counts["k2"] == counts["k3"] == counts["k4"] == 0, f"another kernel launched on the embedding path: {counts}")
    # a batch: 6 denses and 2 LayerNorms a block, the patch dense, ln_pre, ln_post and ln_final; an EVA02
    # image block turns q and k in the rotary epilogue, forms its hidden in the gate pass and adds the
    # attention output's LayerNorm.  At batch 256 every dense has rows enough for the one-kernel GEMM
    rope, glu = (2 * vl if cfg.rope != "none" else 0), (vl if cfg.vision_mlp == "swiglu" else 0)
    fused = {"gemm": 2 * (6 * layers + 1 - rope - glu), "epilogue": 0,
             "layernorm": 2 * (2 * layers + int(cfg.attn_ln) * vl + int(cfg.ln_pre) + 2),
             "rope": 2 * rope, "glu": 2 * glu}
    check(all(counts[k] == v for k, v in fused.items()), f"fused launches {counts}, expected {fused}")
    return counts


def phase_parity(mapper, gpu: str):
    """8 images and captions through ViT-L/14: bf16 kernel path on the card
    against the f32 plain path (the model copied to the CPU, where the
    wrapper runs the plain attention), same weights."""
    import torch

    from clip_retrieval_tpu_torch.models.clip import encode_image, encode_text

    rng = np.random.default_rng(1)
    cfg = mapper.bundle.cfg
    images = torch.from_numpy(rng.integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8))
    tokens = torch.from_numpy(mapper.bundle.tokenize([f"caption {i} for the parity check" for i in range(8)]))
    with torch.inference_mode():
        img_bf16 = encode_image(mapper.model, images.cuda(), compute_dtype=torch.bfloat16).cpu()
        txt_bf16 = encode_text(mapper.model, tokens.cuda(), compute_dtype=torch.bfloat16).cpu()
        img_f32k = encode_image(mapper.model, images.cuda(), compute_dtype=torch.float32).cpu()
    mapper.model.to("cpu")  # in place; moved back below
    try:
        with torch.inference_mode():
            img_ref = encode_image(mapper.model, images)
            txt_ref = encode_text(mapper.model, tokens)
    finally:
        mapper.model.to("cuda")
    cos_img, cos_txt, cos_f32 = min_row_cos(img_bf16, img_ref), min_row_cos(txt_bf16, txt_ref), min_row_cos(img_f32k, img_ref)
    print(f"  [{gpu}] tower parity, bf16 kernel path vs f32 plain path: image min_cos={cos_img:.6f} "
          f"text min_cos={cos_txt:.6f}; f32 kernel path image min_cos={cos_f32:.7f}")
    check(cos_img >= TOWER_MIN_COS and cos_txt >= TOWER_MIN_COS, "tower parity below 0.999")
    check(cos_f32 >= 0.9999, "f32 kernel path disagrees with the f32 plain path")


def phase_times(flash, mapper, gpu: str) -> tuple[tuple[float, float, float], tuple[float, float, float],
                                                  tuple[float, float, float], tuple[float, float, float], float]:
    """Mapper samples/s on device-resident inputs, and K1 against its plain
    version at the main path's two attention shapes in bf16, at SigLIP
    So400m/384's image shape (256, 729, 16x72), the wgmma route's wide
    panels, and at EVA02-L/14-336's (256, 577, 16x64), the DP-64 kernel
    (`time_k1`).  Returns ((K1 ms, plain ms, SDPA ms) at the image tower's
    (256, 257, 16x64), the same at the text tower's (256, 77, 12x64, causal),
    at SigLIP's and at EVA02's image shapes, the worst max abs error of the
    checks)."""
    import torch

    from clip_retrieval_tpu_torch.inference.staging import STAGED_KEY

    cfg = mapper.bundle.cfg
    rng = np.random.default_rng(2)
    batch = {
        "image_tensor": torch.from_numpy(
            rng.integers(0, 256, (BATCH, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)).cuda(),
        "image_filename": [str(i) for i in range(BATCH)],
        STAGED_KEY: BATCH,
    }
    text_batch = {
        "text_tokens": torch.from_numpy(mapper.bundle.tokenize([f"text {i}" for i in range(BATCH)])).cuda(),
        "text": [str(i) for i in range(BATCH)],
        STAGED_KEY: BATCH,
    }
    for name, enable_image, b in (("image", True, batch), ("text", False, text_batch)):
        mapper.enable_image, mapper.enable_text = enable_image, not enable_image
        for _ in range(2):
            mapper(b)
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            mapper(b)  # reads the fp16 embeddings back: one sync per batch
        dt = time.perf_counter() - t0
        print(f"  [{gpu}] mapper {name} tower {MODEL} bf16 b{BATCH}: {iters * BATCH / dt:.1f} samples/s "
              f"({1e3 * dt / iters:.2f} ms/batch, {iters} batches, device-resident inputs)")
    mapper.enable_image = mapper.enable_text = True

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    # the two attention shapes of the main path: image tower, then causal text tower
    image = time_k1(flash, gen, 257, 16, 64, False, gpu)
    text = time_k1(flash, gen, 77, 12, 64, True, gpu)
    siglip = time_k1(flash, gen, 729, 16, 72, False, gpu)
    eva = time_k1(flash, gen, 577, 16, 64, False, gpu)
    return image[:3], text[:3], siglip[:3], eva[:3], max(image[3], text[3], siglip[3], eva[3])


def time_k1(flash, gen, s: int, heads: int, dh: int, causal: bool, gpu: str) -> tuple[float, float, float, float]:
    """K1 at (BATCH, s, heads x dh) bf16: checked against its plain version
    with the bars of phase_kernels, then timed beside it and
    `F.scaled_dot_product_attention` (not on the path).  Returns (K1 ms,
    plain ms, SDPA ms, max abs error)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (torch.randn(BATCH, s, heads * dh, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    err = check_k1(flash, q, k, v, heads, causal)
    kern = lambda: flash.flash_attention_packed(q, k, v, heads, causal=causal)
    plain = lambda: flash.flash_attention_packed_reference(q, k, v, heads, causal=causal)
    split = lambda x: x.view(BATCH, s, heads, dh).transpose(1, 2).contiguous()
    qs, ks, vs = split(q), split(k), split(v)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    for fn in (kern, plain, sdpa):  # warm up; SDPA's first calls pick and build a backend
        for _ in range(3):
            fn()
    times: dict[str, list[float]] = {"K1": [], "plain": []}
    for name, fn in (("plain", plain), ("K1", kern), ("K1", kern), ("plain", plain)):
        times[name].append(cuda_ms(fn, 20))
    k1_ms, plain_ms = float(np.mean(times["K1"])), float(np.mean(times["plain"]))
    sdpa_ms = cuda_ms(sdpa, 20)
    bound, by = attention_bound_ms(BATCH, heads, s, s, dh, 2)
    print(f"  [{gpu}] K1 ({BATCH}, {s}, {heads}x{dh}{', causal' if causal else ''}) bf16: {k1_ms:.4f} ms/call "
          f"(runs {times['K1']}); plain version {plain_ms:.4f} ms/call (runs {times['plain']}); yardstick "
          f"F.scaled_dot_product_attention on (B,H,S,dh) {sdpa_ms:.4f} ms/call (not on the path); bound "
          f"{bound:.4f} ms ({by})")
    return k1_ms, plain_ms, sdpa_ms, err


def attention_bound_ms(b: int, h: int, sq: int, sk: int, dh: int, itemsize: int) -> tuple[float, str]:
    """Least time of one attention call on this card: q, k, v read and o
    written once over the HBM rate against 4·B·H·Sq·Sk·dh MMA FLOPs over the
    dense bf16 peak; (ms, what bounds it)."""
    t_bytes = (2 * b * h * sq * dh + 2 * b * h * sk * dh) * itemsize / HBM_BPS
    t_ops = 4 * b * h * sq * sk * dh / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def zero_counts(kernels: dict):
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels: dict) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def phase_sdpa(flash, kernels: dict, gpu: str) -> tuple[dict, float, float, float, float]:
    """The unpacked `sdpa` entry (impl 'auto') on (256, 16, 257, 64) bf16, the
    image tower's attention shape: it must run through K2 and only K2; then
    K2 against its plain version (K1's bars) and timed beside it and
    `F.scaled_dot_product_attention` (not on the path).  Returns (launch
    counts of the path, K2 ms, plain ms, SDPA ms, max abs err)."""
    import torch
    import torch.nn.functional as F

    from clip_retrieval_tpu_torch.ops.attention import sdpa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    q, k, v = (torch.randn(BATCH, 16, 257, 64, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    zero_counts(kernels)
    out = sdpa(q, k, v)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    check(counts == {**dict.fromkeys(kernels, 0), "k2": 1}, f"sdpa launched {counts}, expected K2 once")
    ref = flash.flash_attention_reference(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    check(err <= BF16_MAX_ABS, f"sdpa output off by {err:.3e}")
    err = max(err, check_k2(flash, q, k, v, causal=False))
    kern = lambda: flash.flash_attention(q, k, v)
    plain = lambda: flash.flash_attention_reference(q, k, v)
    lib = lambda: F.scaled_dot_product_attention(q, k, v)
    for fn in (kern, plain, lib):  # warm up; SDPA's first calls pick a backend
        for _ in range(3):
            fn()
    times: dict[str, list[float]] = {"K2": [], "plain": []}
    for name, fn in (("plain", plain), ("K2", kern), ("K2", kern), ("plain", plain)):
        times[name].append(cuda_ms(fn, 20))
    k2_ms, plain_ms, lib_ms = float(np.mean(times["K2"])), float(np.mean(times["plain"])), cuda_ms(lib, 20)
    bound, by = attention_bound_ms(BATCH, 16, 257, 257, 64, 2)
    print(f"  [{gpu}] sdpa (impl auto) on ({BATCH}, 16, 257, 64) bf16: K2 launches {counts['k2']}, max abs "
          f"{err:.3e}; K2 {k2_ms:.4f} ms/call (runs {times['K2']}); plain version {plain_ms:.4f} ms/call (runs "
          f"{times['plain']}); F.scaled_dot_product_attention {lib_ms:.4f} ms/call; bound {bound:.4f} ms ({by})")
    return counts, k2_ms, plain_ms, lib_ms, err


# --------------------------------------------------------------------------
# slice 5: the ResNet towers, checkpoint conversion, M-CLIP
# --------------------------------------------------------------------------


def staged_images(n: int, size: int, seed: int) -> dict:
    """A device-resident uint8 batch as `DeviceStagingReader` hands it over."""
    import torch

    from clip_retrieval_tpu_torch.inference.staging import STAGED_KEY

    rng = np.random.default_rng(seed)
    return {"image_tensor": torch.from_numpy(rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)).cuda(),
            "image_filename": [str(i) for i in range(n)], STAGED_KEY: n}


def images_per_s(mapper, batch: dict, iters: int) -> tuple[float, float]:
    """Image embeddings/s of the mapper on a device-resident batch (host
    clock; each call reads the fp16 embeddings back), and the peak device
    memory of those calls in GB."""
    import torch

    mapper.enable_image, mapper.enable_text = True, False
    for _ in range(2):
        mapper(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        mapper(batch)
    rate = iters * batch["image_tensor"].shape[0] / (time.perf_counter() - t0)
    return rate, torch.cuda.max_memory_allocated() / 1e9


def rn_parity(model, tokenizer, cfg, gpu: str, weights: str, bar: bool = True, n: int = 8):
    """A ResNet CLIP's bf16 path against its f32 plain path on the same
    weights: the image tower in bf16 against f32 on the card (it holds no
    kernel of the port; cuDNN with TF32 off), the text tower in bf16 through
    K1 against f32 on the CPU, where the wrapper runs K1's plain version.
    Fails below TOWER_MIN_COS when `bar`; otherwise only reports."""
    import torch

    from clip_retrieval_tpu_torch.models.clip import encode_image, encode_text

    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (n, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)).cuda()
    tokens = torch.from_numpy(tokenizer([f"caption {i} for the {cfg.name} parity check" for i in range(n)],
                                        cfg.context_length))
    with torch.inference_mode():
        img_bf16 = encode_image(model, images, compute_dtype=torch.bfloat16)
        img_f32 = encode_image(model, images, compute_dtype=torch.float32)
        txt_bf16 = encode_text(model, tokens.cuda(), compute_dtype=torch.bfloat16).cpu()
    model.text.to("cpu")  # in place; moved back below
    try:
        with torch.inference_mode():
            txt_ref = encode_text(model, tokens)
    finally:
        model.text.to("cuda")
    finite = bool(torch.isfinite(img_bf16).all() and torch.isfinite(txt_bf16).all())
    cos_img, cos_txt = min_row_cos(img_bf16, img_f32), min_row_cos(txt_bf16, txt_ref)
    print(f"  [{gpu}] {cfg.name} ({weights}) bf16 path vs f32 plain path, {n} images and captions: image "
          f"min_cos={cos_img:.6f} (f32 on the card, TF32 off), text min_cos={cos_txt:.6f} (f32 plain K1 on the CPU), "
          f"finite={finite}" + ("" if bar else "; reported, not held to the bar"))
    check(finite and img_bf16.shape == (n, cfg.embed_dim), f"{cfg.name} image embeddings {tuple(img_bf16.shape)}")
    check(not bar or (cos_img >= TOWER_MIN_COS and cos_txt >= TOWER_MIN_COS),
          f"{cfg.name} tower parity below {TOWER_MIN_COS}")


def phase_rn_main_path(kernels: dict, gpu: str) -> dict:
    """The `inference` entry point over the 512 JPEG+caption samples at RN50
    bf16 b256, image and text: K1 runs in the text tower only (2 batches x 12
    layers).  Returns the launch counts."""
    from clip_retrieval_tpu_torch.inference.main import main as clip_inference
    from clip_retrieval_tpu_torch.models.configs import get_config

    cfg = get_config(RN_MODEL)
    out = f"{WORK_DIR}/out_rn50"
    zero_counts(kernels)
    t0 = time.perf_counter()
    clip_inference(input_dataset=f"{WORK_DIR}/corpus", output_folder=out, batch_size=BATCH, num_prepro_workers=8,
                   clip_model=RN_MODEL, device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    for sub, name in (("img_emb", "img_emb_0.npy"), ("text_emb", "text_emb_0.npy")):
        emb = np.load(f"{out}/{sub}/{name}")
        norms = np.linalg.norm(emb.astype(np.float32), axis=-1)
        print(f"  {RN_MODEL} {sub}: shape={emb.shape} dtype={emb.dtype} norm range [{norms.min():.5f}, "
              f"{norms.max():.5f}]")
        check(emb.shape == (SAMPLES, cfg.embed_dim) and emb.dtype == np.float16, f"{sub} has shape {emb.shape}")
        check(bool(np.isfinite(emb).all()), f"{RN_MODEL} {sub} has non-finite values")
        check(bool(np.all(np.abs(norms - 1) <= 1e-2)), f"{RN_MODEL} {sub} norms leave 1 ± 1e-2")
    expected = 2 * cfg.text_layers  # 2 batches x text layers; the image tower launches no kernel of the port
    print(f"  [{gpu}] {RN_MODEL} main path wall {wall:.2f} s on the host clock, 2 batches, including model init and "
          f"JPEG decode; launches {counts}")
    check(counts["k1"] == expected, f"K1 launched {counts['k1']} times on the {RN_MODEL} path, expected {expected}")
    check(counts["k2"] == counts["k3"] == counts["k4"] == 0, f"another kernel launched on the {RN_MODEL} path")
    return counts


def rn_profile(mapper, batch: dict, gpu: str) -> dict:
    """Device time of RN50's image tower over 3 device-resident batches by
    `torch.profiler`, grouped by operator: convolutions, the folded-BN/relu
    epilogues with the casts, pooling, the attention pool.  Returns
    {group: share of the device time}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    mapper(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            mapper(batch)
        torch.cuda.synchronize()
    groups = {"convolutions": ("conv",), "pooling": ("avg_pool",),
              "attention pool (matmuls, softmax, mean, concat)": ("mm", "matmul", "softmax", "mean", "cat", "einsum"),
              "epilogues and casts (mul, add, relu, copy)": ("mul", "add", "relu", "clamp", "copy", "to", "div",
                                                             "sub")}
    totals = dict.fromkeys([*groups, "other"], 0.0)
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        if not ev.key.startswith("aten::") or t <= 0:
            continue  # kernel rows repeat their op's time; sum the op rows only
        op = ev.key[len("aten::"):]
        group = next((g for g, keys in groups.items() if any(k in op for k in keys)), "other")
        totals[group] += t
        rows.append((t, ev.key, ev.count))
    total = sum(totals.values())
    check(total > 0, "torch.profiler reported no device time for the RN50 image tower")
    for t, key, count in sorted(rows, reverse=True)[:12]:
        print(f"    {key:<40} {t / 1e3 / 3:9.3f} ms/batch {100 * t / total:6.2f} %  ({count} calls)")
    shares = {g: t / total for g, t in totals.items()}
    print(f"  [{gpu}] {RN_MODEL} image tower b{BATCH} bf16 device time {total / 1e3 / 3:.3f} ms/batch (torch.profiler, "
          f"3 batches): " + ", ".join(f"{g} {100 * v:.2f} %" for g, v in shares.items()))
    return shares


def phase_rn_towers(gpu: str):
    """RN50 and RN50x64 (random weights from `init_clip`, full width): the
    bf16 path against the f32 plain path (`rn_parity`), reported on
    `init_clip`'s weights and held to the bar once every bottleneck's conv3
    scale (its folded bn3 weight) is RN_BN3_SCALE; image embeddings/s of the
    mapper on device-resident batches (RN50 at b256, RN50x64 at b64); a
    `torch.profiler` breakdown of RN50's image tower.

    Why the scale: `init_clip` gives every folded BN scale 1 (the JAX
    package's init), so the residual stream grows through RN50x64's 64
    blocks, the attention pool's logits grow with it, and its softmax turns
    bf16's rounding of the features into a different embedding, in the JAX
    package's forward as in this one.  openai's CLIP initialises every bn3
    weight to 0 (model.py, `initialize_parameters`), so a checkpoint's
    residual branches start at nothing; at 0.25 the stream stays small."""
    import torch

    from clip_retrieval_tpu_torch.inference.mapper import ClipMapper

    rates = {}
    for name, batch_size in ((RN_MODEL, BATCH), (RN_WIDE, RN_WIDE_BATCH)):
        mapper = ClipMapper(enable_image=True, enable_text=False, clip_model=name, batch_size=batch_size,
                            device="cuda")
        cfg = mapper.bundle.cfg
        rn_parity(mapper.model, mapper.bundle.tokenize, cfg, gpu, "init_clip's weights", bar=False)
        with torch.no_grad():
            for stage in mapper.model.visual.stages:
                for blk in (stage.head, *stage.tail):
                    blk.conv3.scale.fill_(RN_BN3_SCALE)
        rn_parity(mapper.model, mapper.bundle.tokenize, cfg, gpu, f"init_clip's weights, conv3 scale {RN_BN3_SCALE}")
        batch = staged_images(batch_size, cfg.image_size, 5)
        rates[name], peak_gb = images_per_s(mapper, batch, 10)
        n_params = sum(p.numel() for p in mapper.model.visual.parameters())
        print(f"  [{gpu}] mapper {name} image tower ({n_params / 1e6:.1f}M parameters, {cfg.image_size} px) bf16 "
              f"b{batch_size}: {rates[name]:.1f} img/s (10 batches, device-resident inputs), peak device memory "
              f"{peak_gb:.1f} GB")
        if name == RN_MODEL:
            shares = rn_profile(mapper, batch, gpu)
        del mapper, batch
        torch.cuda.empty_cache()
    return rates, shares


# --------------------------------------------------------------------------
# the /knn-service query path
# --------------------------------------------------------------------------


def check_k3(int8scan, args) -> float:
    """K3 against its plain version on the same inputs: bit-identical, so the
    -inf sets are equal and the finite entries differ by 0.  Returns the max
    abs difference of the finite entries (0.0)."""
    import torch

    got = int8scan.int8_gather_scan(*args)
    ref = int8scan.int8_gather_scan_reference(*args)
    torch.cuda.synchronize()
    b, d = args[0].shape
    where = f"B={b} Lc={args[2].shape[1]} d={d} U={args[5].shape[0]}"
    check(got.shape == ref.shape, f"K3 shape {tuple(got.shape)} vs {tuple(ref.shape)} at {where}")
    check(torch.equal(torch.isneginf(got), torch.isneginf(ref)), f"K3 -inf set differs at {where}")
    fin = torch.isfinite(ref)
    err = (got[fin] - ref[fin]).abs().max().item() if bool(fin.any()) else 0.0
    check(torch.equal(got, ref), f"K3 not bit-identical to its plain version at {where} (max abs {err:.3e})")
    return err


def phase_k3(int8scan) -> float:
    """K3 against its plain version at B ∈ {1,3,17,32,64} × Lc ∈ {32,256} ×
    d ∈ {512,768,1024}, selections with repeats and the all-padding chunk."""
    import torch

    from clip_retrieval_tpu_torch.ops.int8mm import quantize_rows_device

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    nchunks, worst, n = 24, 0.0, 0
    sel = torch.tensor([5, 5, nchunks - 1, 0, 17, 5, 23, 11], dtype=torch.int32, device="cuda")
    for d in (512, 768, 1024):
        for lc in (32, 256):
            rows = torch.randint(-127, 128, (nchunks, lc, d), generator=gen, device="cuda", dtype=torch.int8)
            scales = torch.rand((nchunks, lc), generator=gen, device="cuda") + 0.5
            pos = torch.arange(nchunks * lc, dtype=torch.int32, device="cuda").reshape(nchunks, lc)
            pad = torch.rand((nchunks, lc), generator=gen, device="cuda") < 0.1
            pad[-1] = True  # the all-padding chunk
            scales[pad] = 0.0
            pos[pad] = -1
            for b in (1, 3, 17, 32, 64):
                qq, qs = quantize_rows_device(torch.randn(b, d, generator=gen, device="cuda"))
                worst = max(worst, check_k3(int8scan, (qq, qs, rows, scales, pos, sel)))
                n += 1
    print(f"  K3 vs plain: {n} geometries (B 1/3/17/32/64 x Lc 32/256 x d 512/768/1024, U=8 with repeats and the "
          f"all-padding chunk) bit-identical; max abs err {worst}")
    return worst


def phase_index(gpu: str, other_indices: dict):
    """Generate the synthetic 10M x 768 IVF-int8 index on the card
    (list-grouped by construction: random unit centroids, seeded multinomial
    list sizes, rows normalize(c_l + 0.75·g/√d)), quantize it with
    `quantize_rows_device`, save it with a `caption` parquet and
    indices_paths.json (with `other_indices` beside it).  Returns (index on
    the card, ids of the queried rows, their f32 originals)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch

    from clip_retrieval_tpu_torch.index.ivf_int8 import IVFInt8Index
    from clip_retrieval_tpu_torch.ops.int8mm import quantize_rows_device

    t0 = time.perf_counter()
    folder = os.path.join(WORK_DIR, "index")
    os.makedirs(os.path.join(folder, "metadata"), exist_ok=True)
    rng = np.random.default_rng(5)
    sizes = rng.multinomial(N_ROWS, np.full(NLIST, 1.0 / NLIST))
    offsets = np.zeros(NLIST + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    cent = torch.randn(NLIST, DIM, generator=gen, device="cuda")
    cent /= cent.norm(dim=1, keepdim=True)
    owner = torch.repeat_interleave(torch.arange(NLIST, device="cuda"), torch.from_numpy(sizes).cuda())
    q_vectors = np.empty((N_ROWS, DIM), np.int8)
    scales = np.empty((N_ROWS,), np.float32)
    sample_pos = np.sort(rng.choice(N_ROWS, N_QUERIES, replace=False))
    originals = np.empty((N_QUERIES, DIM), np.float32)
    noise = 0.75 / math.sqrt(DIM)
    for a in range(0, N_ROWS, GEN_BLOCK):
        b = min(a + GEN_BLOCK, N_ROWS)
        x = cent[owner[a:b]] + noise * torch.randn(b - a, DIM, generator=gen, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        qb, sb = quantize_rows_device(x)
        q_vectors[a:b] = qb.cpu().numpy()
        scales[a:b] = sb.cpu().numpy()
        m = (sample_pos >= a) & (sample_pos < b)
        if m.any():
            originals[m] = x[torch.from_numpy(sample_pos[m] - a).cuda()].cpu().numpy()
        del x
    list_ids = rng.permutation(N_ROWS).astype(np.int64)
    t_gen = time.perf_counter() - t0
    index = IVFInt8Index(DIM, cent.cpu().numpy(), offsets, list_ids, q_vectors, scales, nprobe=NPROBE, device="cuda")
    index.save(os.path.join(folder, "image.index"))
    captions = pc.binary_join_element_wise("row", pc.cast(pa.array(np.arange(N_ROWS)), pa.string()), " ")
    pq.write_table(pa.table({"caption": captions}), os.path.join(folder, "metadata", "metadata_0.parquet"))
    with open(os.path.join(WORK_DIR, "indices_paths.json"), "w") as f:
        json.dump({INDEX_NAME: folder, **other_indices}, f)
    t_save = time.perf_counter() - t0 - t_gen
    index._ensure_device()
    torch.cuda.synchronize()
    rows = index._device["rows"]
    cos = torch.nn.functional.cosine_similarity(torch.from_numpy(originals).cuda(), cent[owner[sample_pos]], dim=1)
    print(f"  [{gpu}] index: {N_ROWS} x {DIM}, nlist {NLIST}, nprobe {NPROBE}; list sizes {sizes.min()}..{sizes.max()}"
          f"; Lc {rows.shape[1]}, {rows.shape[0]} chunks, {rows.numel() / 1e9:.3f} GB int8 on the card; row-centroid"
          f" cosine {cos.mean().item():.3f}; generated in {t_gen:.1f} s, saved with metadata in {t_save:.1f} s, "
          f"device image in {time.perf_counter() - t0 - t_gen - t_save:.1f} s")
    check(rows.shape[1] == 256, f"Lc {rows.shape[1]}, expected 256")
    return index, list_ids[sample_pos], originals


def phase_pq_corpus(gpu: str) -> tuple[str, np.ndarray]:
    """Write the index-build corpus in the `inference` writer's layout:
    img_emb/img_emb_{0..3}.npy (fp16) and metadata/metadata_{0..3}.parquet
    (image_path, caption).  Rows are generated on the card from a seed:
    PQ_CENTRES random unit centres, rows normalize(c + 0.75·g/√d).  Returns
    (folder, the rows in host memory)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    t0 = time.perf_counter()
    folder = os.path.join(WORK_DIR, "pq_corpus")
    for sub in ("img_emb", "metadata"):
        os.makedirs(os.path.join(folder, sub))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    cent = torch.randn(PQ_CENTRES, DIM, generator=gen, device="cuda")
    cent /= cent.norm(dim=1, keepdim=True)
    rows = np.empty((PQ_ROWS, DIM), np.float16)
    per = PQ_ROWS // PQ_SHARDS
    for s in range(PQ_SHARDS):
        a, b = s * per, PQ_ROWS if s == PQ_SHARDS - 1 else (s + 1) * per
        owner = torch.randint(0, PQ_CENTRES, (b - a,), generator=gen, device="cuda")
        x = cent[owner] + (0.75 / math.sqrt(DIM)) * torch.randn(b - a, DIM, generator=gen, device="cuda")
        rows[a:b] = (x / x.norm(dim=1, keepdim=True)).half().cpu().numpy()
        np.save(os.path.join(folder, "img_emb", f"img_emb_{s}.npy"), rows[a:b])
        pq.write_table(pa.table({"image_path": [f"{i}.jpg" for i in range(a, b)],
                                 "caption": [f"row {i}" for i in range(a, b)]}),
                       os.path.join(folder, "metadata", f"metadata_{s}.parquet"))
    print(f"  [{gpu}] index-build corpus: {PQ_ROWS} x {DIM} fp16 in {PQ_SHARDS} shards + caption parquets, "
          f"{PQ_CENTRES} centres, written in {time.perf_counter() - t0:.1f} s")
    return folder, rows


def phase_pq_build(corpus: str, kernels: dict, gpu: str) -> tuple[str, dict]:
    """The `index` entry point (`clip_index`) over the corpus with PQ_KEY,
    nprobe calibrated (recall@10 >= 0.95 against an exact brute force on the
    card) and recall scored; K4 scores every calibration and recall search,
    and no other kernel runs.  Returns (index folder, launch counts)."""
    from clip_retrieval_tpu_torch.index.build import clip_index

    folder = os.path.join(WORK_DIR, "pq_index")
    zero_counts(kernels)
    t0 = time.perf_counter()
    clip_index(corpus, folder, index_key=PQ_KEY, nprobe=None, compute_recall=True, device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    with open(os.path.join(folder, "image.json")) as f:
        infos = json.load(f)
    with open(os.path.join(folder, "image.index", "header.json")) as f:
        header = json.load(f)
    cal = header["calibration"]
    print(f"  [{gpu}] clip_index {PQ_KEY} over {PQ_ROWS} x {DIM}: train_s {infos['train_s']}, encode_s "
          f"{infos['encode_s']}, build_seconds {infos['build_seconds']:.1f} (wall {wall:.1f} s with save and "
          f"recall); calibrated nprobe {header['nprobe']}, rerank_factor {header['rerank_factor']}, recall@10 "
          f"{cal['recall_achieved']} (curve {cal['recall_curve']}, rerank curve {cal.get('rerank_curve')}); "
          f"recall@40 {infos['recall@40']:.4f} ({infos['n_queries']} queries); launches {counts}")
    check(not cal["target_missed"], f"nprobe calibration missed its target: {cal}")
    check(counts["k4"] > 0, "K4 did not launch on the index path")
    check(counts["k1"] == counts["k2"] == counts["k3"] == 0, f"another kernel launched on the index path: {counts}")
    check(os.path.exists(os.path.join(folder, "metadata", "metadata_0.parquet")), "metadata was not copied")
    return folder, counts


def phase_pq_probe(folder: str, pq_rows, pq_ids, gpu: str) -> np.ndarray:
    """Which of the queried stored rows have their own list (the one the
    build filed them in, argmax x·c − ½‖c‖²) among the lists the index probes
    for them (its top-nprobe by q·c, on the device route's ops).  Only those
    rows can come back first.  Prints the rank of each row's own list under
    both rules and the centroids' norms; returns the (N_QUERIES,) mask."""
    import torch

    from clip_retrieval_tpu_torch.index.flat import to_device
    from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex, probe

    ix = IVFPQIndex.load(os.path.join(folder, "image.index"), device="cuda")
    nprobe = min(ix.nprobe, ix.nlist)
    own = np.searchsorted(ix.list_offsets, ix._positions(pq_ids), side="right") - 1
    coarse = to_device(ix.coarse_centroids, ix.device)
    qr = to_device(pq_rows[pq_ids].astype(np.float32), ix.device)
    if ix.rotation is not None:
        qr = qr @ to_device(ix.rotation, ix.device)
    _, probe_idx = probe(qr, coarse, nprobe)
    probed = (probe_idx.cpu().numpy() == own[:, None]).any(axis=1)
    scores = qr @ coarse.T
    fill = scores - 0.5 * (coarse * coarse).sum(1)
    own_t = torch.from_numpy(own).to(ix.device)[:, None]
    rank_qc = (scores > scores.gather(1, own_t)).sum(1).cpu().numpy()
    rank_fill = (fill > fill.gather(1, own_t)).sum(1).cpu().numpy()
    norms = np.linalg.norm(ix.coarse_centroids, axis=1)
    print(f"  [{gpu}] {PQ_INDEX} probe reading: {int(probed.sum())}/{len(pq_ids)} queried rows have their own list "
          f"among the {nprobe} probed by q·c; rank of the own list by q·c: median {int(np.median(rank_qc))}, max "
          f"{int(rank_qc.max())}, >= nprobe for {int((rank_qc >= nprobe).sum())}; by the filing rule "
          f"x·c - ½‖c‖²: max {int(rank_fill.max())}; centroid norms min/p5/p50/p95/max "
          f"{'/'.join(f'{v:.3f}' for v in np.percentile(norms, [0, 5, 50, 95, 100]))}")
    return probed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(port: int, method: str, path: str, body=None, timeout: float = 300.0):
    """One request to the local server: (status, parsed JSON or raw bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
        ctype = r.getheader("Content-Type", "")
        return r.status, (json.loads(raw) if ctype.startswith("application/json") else raw)
    finally:
        conn.close()


def knn(port: int, index: str = INDEX_NAME, **body):
    status, res = http_json(port, "POST", "/knn-service",
                            {"modality": "image", "num_images": TOPK, "indice_name": index, **body})
    check(status == 200, f"/knn-service answered {status}: {str(res)[:300]}")
    return res


def check_results(res, where: str):
    check(len(res) == TOPK, f"{where}: {len(res)} results, expected {TOPK}")
    sims = [r["similarity"] for r in res]
    check(all(a >= b for a, b in zip(sims, sims[1:])), f"{where}: similarities not descending")
    check(all(np.isfinite(sims)), f"{where}: non-finite similarity")
    check(all(r.get("caption") == f"row {r['id']}" for r in res), f"{where}: caption does not match the id")


def jpeg_b64(seed: int) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (300, 260, 3), dtype=np.uint8)).save(buf, format="JPEG", quality=90)
    return base64.b64encode(buf.getvalue()).decode()


def concurrent_embedding_queries(port: int, queries, ids, per_client: int = 1, index: str = INDEX_NAME,
                                 first=None) -> float:
    """CLIENTS threads, released together, each sending `per_client`
    embedding queries; the first result must be the queried row (for query j
    where `first[j]`, every query when `first` is None).  Returns the wall
    seconds of the burst."""
    barrier = threading.Barrier(CLIENTS + 1)
    errors: list[str] = []

    def client(c: int):
        barrier.wait()
        for r in range(per_client):
            j = (c + r * CLIENTS) % len(queries)
            try:
                res = knn(port, index=index, embedding_input=queries[j].tolist())
                if (first is None or first[j]) and res[0]["id"] != int(ids[j]):
                    errors.append(f"client {c}: first id {res[0]['id']} != {ids[j]}")
            except Exception as e:  # reported below
                errors.append(f"client {c}: {e}")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"concurrent queries failed: {errors[:3]}")
    return wall


def phase_serve(kernels: dict, sample_ids, originals, pq_rows, pq_ids, pq_probed, gpu: str) -> tuple[dict, list, list]:
    """The `back` entry point on both generated indices, driven over HTTP.
    On the IVF-PQ index, the stored rows whose own list is probed
    (`pq_probed`) must come back first.  Returns (launch counts of the path,
    served ids of the serial embedding queries on the IVF-int8 index, and on
    the IVF-PQ index)."""
    from clip_retrieval_tpu_torch.back.app import clip_back

    port = free_port()
    boot_error: list[BaseException] = []

    def boot():
        try:
            clip_back(indices_paths=os.path.join(WORK_DIR, "indices_paths.json"), port=port, clip_model=MODEL,
                      device="cuda", provide_aesthetic_embeddings=False, enable_faiss_memory_mapping=True,
                      http_backend="wsgiref")
        except BaseException as e:  # reported by the poll below
            boot_error.append(e)

    zero_counts(kernels)
    t0 = time.perf_counter()
    server = threading.Thread(target=boot, daemon=True, name="clip_back")
    server.start()
    while True:
        check(server.is_alive(), f"clip_back ended during boot: {boot_error[:1]}")
        try:
            if http_json(port, "GET", "/health", timeout=5)[0] == 200:
                break
        except OSError:
            pass
        check(time.perf_counter() - t0 < 600, "clip_back did not answer /health within 600 s")
        time.sleep(0.5)
    print(f"  [{gpu}] clip_back up in {time.perf_counter() - t0:.1f} s (model init, index load and device image, "
          f"warm-up); launches during boot: {read_counts(kernels)}")

    def counts():
        return read_counts(kernels)["k1"], read_counts(kernels)["k3"]

    # (a) serial embedding queries: b=1 batches (the exact route, as every batch size)
    _, k3_0 = counts()
    served, first_sims = [], []
    for i in range(N_QUERIES):
        res = knn(port, embedding_input=originals[i].tolist())
        check_results(res, f"embedding query {i}")
        check(res[0]["id"] == int(sample_ids[i]) and res[0]["similarity"] >= 0.98,
              f"embedding query {i}: first result {res[0]['id']} ({res[0]['similarity']:.4f}), expected "
              f"{sample_ids[i]} with similarity >= 0.98")
        served.append([r["id"] for r in res])
        first_sims.append(res[0]["similarity"])
    k1_a, k3_a = counts()
    check(k3_a > k3_0, "K3 did not launch for the serial embedding queries")
    print(f"  (a) {N_QUERIES} serial embedding queries: every first result is the queried row, similarity "
          f"{min(first_sims):.5f}..{max(first_sims):.5f}; K3 launches +{k3_a - k3_0}")
    # (b) text queries
    for i in range(8):
        check_results(knn(port, text=f"a photo of query number {i}, the {i}th of eight"), f"text query {i}")
    k1_b, k3_b = counts()
    check(k1_b > k1_a, "K1 did not launch for the text queries")
    print(f"  (b) 8 text queries: 40 results each, descending, captions match; K1 launches +{k1_b - k1_a}")
    # (c) base64 JPEG image queries
    for i in range(2):
        check_results(knn(port, image=jpeg_b64(10 + i)), f"image query {i}")
    k1_c, _ = counts()
    check(k1_c > k1_b, "K1 did not launch for the image queries")
    print(f"  (c) 2 base64 JPEG queries: 200; K1 launches +{k1_c - k1_b}")
    # (d) dedup
    res = knn(port, embedding_input=originals[0].tolist(), deduplicate=True)
    ids = [r["id"] for r in res]
    check(0 < len(ids) <= TOPK and len(set(ids)) == len(ids) and ids[0] == int(sample_ids[0]),
          "deduplicated query answered badly")
    print(f"  (d) deduplicate=true: {len(ids)} results")
    # (e) metadata and index list
    status, metas = http_json(port, "POST", "/metadata", {"ids": [int(i) for i in sample_ids[:5]],
                                                          "indice_name": INDEX_NAME})
    check(status == 200 and [m["metadata"]["caption"] for m in metas] == [f"row {i}" for i in sample_ids[:5]],
          "/metadata answered badly")
    status, names = http_json(port, "GET", "/indices-list")
    check(status == 200 and names == [INDEX_NAME, PQ_INDEX, INT8_INDEX], f"/indices-list answered {status} {names}")
    status, body = http_json(port, "GET", "/metrics")
    check(status == 200 and b"full_knn_request_time_count" in body, "/metrics answered badly")
    print("  (e) /metadata, /indices-list, /metrics: 200 and as expected")
    # (f) concurrent embedding queries: batches ≥ 2 → the exact route
    _, k3_e = counts()
    max_batch, known = 0, set()
    for _ in range(3):
        concurrent_embedding_queries(port, originals, sample_ids)
        status, stats = http_json(port, "GET", "/serving-stats")
        check(status == 200, "/serving-stats failed")
        known = set(stats["search"])
        sizes = [int(s) for key, row in stats["search"].items() if key.endswith(f"-k{TOPK}")
                 for s in row["batch_sizes"]]
        max_batch = max(sizes or [0])
        if max_batch >= 2:
            break
    _, k3_f = counts()
    check(max_batch >= 2, "32 concurrent queries never formed a search batch of 2 or more")
    check(k3_f > k3_e, "K3 did not launch for the concurrent queries (exact route)")
    print(f"  (f) {CLIENTS} concurrent embedding queries: largest search batch {max_batch}; K3 launches "
          f"+{k3_f - k3_e}; search batch sizes {stats['search']}")
    # (g) the IVF-PQ index: serial stored-row queries (B=1), each whose own list is probed returns its row first
    k4_0 = read_counts(kernels)["k4"]
    pq_served, pq_sims, n_first = [], [], 0
    pq_queries = pq_rows[pq_ids].astype(np.float32)
    for i, rid in enumerate(pq_ids):
        res = knn(port, index=PQ_INDEX, embedding_input=pq_queries[i].tolist())
        check_results(res, f"IVF-PQ embedding query {i}")
        n_first += res[0]["id"] == int(rid)
        check(res[0]["id"] == int(rid) or not pq_probed[i],
              f"IVF-PQ query {i}: own list probed, first result {res[0]['id']}, expected {rid}")
        pq_served.append([r["id"] for r in res])
        pq_sims.append(res[0]["similarity"])
    k4_g = read_counts(kernels)["k4"]
    check(k4_g > k4_0, "K4 did not launch for the IVF-PQ serial queries")
    print(f"  (g) {len(pq_ids)} serial stored-row queries on {PQ_INDEX}: {n_first} return the queried row first, "
          f"every one of the {int(pq_probed.sum())} whose own list is probed; first similarity "
          f"{min(pq_sims):.5f}..{max(pq_sims):.5f}; K4 launches +{k4_g - k4_0}")
    # (h) a text query on the IVF-PQ index
    check_results(knn(port, index=PQ_INDEX, text="a photo of the query on the IVF-PQ index"), "IVF-PQ text query")
    # (i) 32 concurrent clients on the IVF-PQ index
    concurrent_embedding_queries(port, pq_queries, pq_ids, index=PQ_INDEX, first=pq_probed)
    status, stats = http_json(port, "GET", "/serving-stats")
    pq_sizes = [int(s) for key, row in stats["search"].items() if key not in known for s in row["batch_sizes"]]
    k4_i = read_counts(kernels)["k4"]
    check(k4_i > k4_g, "K4 did not launch for the IVF-PQ text and concurrent queries")
    print(f"  (h, i) text query and {CLIENTS} concurrent clients on {PQ_INDEX}: 200, the queried row first where "
          f"its list is probed; largest search batch {max(pq_sizes or [0])}; K4 launches +{k4_i - k4_g}")
    c = read_counts(kernels)
    print(f"  served path launches: {c}")
    return {**c, "port": port}, served, pq_served


def phase_recall(index, int8scan, originals, served) -> np.ndarray:
    """recall@40 of the served answers of (a) against an exhaustive scan of
    every chunk by K3's plain version, in blocks of chunks with a running
    top-k merge.  Returns the scan's ids (N_QUERIES, 40)."""
    import torch

    from clip_retrieval_tpu_torch.ops.int8mm import quantize_rows_device
    from clip_retrieval_tpu_torch.ops.topk import topk_merge

    dv = index._device
    qq, qs = quantize_rows_device(torch.from_numpy(originals).cuda())
    nchunks = dv["rows"].shape[0]
    best_v = best_p = None
    t0 = time.perf_counter()
    for a in range(0, nchunks, 2048):
        sel = torch.arange(a, min(a + 2048, nchunks), dtype=torch.int32, device="cuda")
        scores = int8scan.int8_gather_scan_reference(qq, qs, dv["rows"], dv["scales"], dv["pos"], sel)
        vals, idx = torch.topk(scores, TOPK, dim=1)
        pos = dv["pos"][a : a + sel.shape[0]].reshape(-1)[idx].long()
        best_v, best_p = (vals, pos) if best_v is None else topk_merge(best_v, best_p, vals, pos, TOPK)
    truth = index._positions_to_ids(best_p.cpu().numpy())
    recall = float(np.mean([len(set(s) & set(t.tolist())) / TOPK for s, t in zip(served, truth)]))
    print(f"  recall@{TOPK} of the {len(served)} served embedding queries vs the exhaustive plain scan of "
          f"{nchunks} chunks: {recall:.4f} (scan {time.perf_counter() - t0:.1f} s)")
    check(recall >= MIN_RECALL, f"recall@{TOPK} {recall:.4f} < {MIN_RECALL}")
    return truth


def p50_ms(fn, iters: int, warm: int = 3) -> tuple[float, float]:
    """(p50, p90) in ms on the host clock; fn ends in a read-back."""
    for _ in range(warm):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return 1e3 * samples[len(samples) // 2], 1e3 * samples[int(len(samples) * 0.9)]


def profile_search(index, qb, iters: int = 10) -> float:
    """Device time per search batch from torch.profiler ("Self CUDA time
    total" over `iters` batches); prints the top device operators.  Returns
    nan when the profiler reports no device total."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    index.search_and_reconstruct(qb, TOPK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            index.search_and_reconstruct(qb, TOPK)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12)
    print(table)
    m = re.search(r"Self CUDA time total: ([\d.]+)(us|ms|s)\b", table)
    if m is None:
        return float("nan")
    return float(m.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[m.group(2)] / iters


def phase_query_times(index, int8scan, originals, sample_ids, port: int, gpu: str) -> tuple[float, ...]:
    """K3 vs plain and the stock gather + `torch._int_mm` path at the served
    shape, search-batch p50 by route, HTTP p50 and QPS.  Returns (K3 ms,
    plain ms, K3 max abs err, K3 bound ms, stock path ms or None)."""
    import torch

    from clip_retrieval_tpu_torch.index.ivf_int8 import select_probes
    from clip_retrieval_tpu_torch.ops.int8mm import quantize_rows_device

    dv = index._device
    q32 = torch.from_numpy(originals[:32]).cuda()
    per_q = select_probes(q32 @ dv["coarse"].T, NPROBE).cpu().numpy()
    sel = torch.from_numpy(index._union_chunk_sel(per_q)).cuda()
    qq, qs = quantize_rows_device(q32)
    args = (qq, qs, dv["rows"], dv["scales"], dv["pos"], sel)
    err = check_k3(int8scan, args)
    kern = lambda: int8scan.int8_gather_scan(*args)
    plain = lambda: int8scan.int8_gather_scan_reference(*args)
    for fn in (kern, plain):
        fn()
    times: dict[str, list[float]] = {"K3": [], "plain": []}
    for name, fn in (("plain", plain), ("K3", kern), ("K3", kern), ("plain", plain)):
        times[name].append(cuda_ms(fn, 20))
    k3_ms, plain_ms = float(np.mean(times["K3"])), float(np.mean(times["plain"]))
    u, lc = sel.shape[0], dv["rows"].shape[1]
    gbytes = (u * lc * (DIM + 8) + 32 * u * lc * 4) / 1e9
    print(f"  [{gpu}] K3 at the served shape (B=32, U={u} chunks of a real batch's union, {index.last_union_chunks} "
          f"before padding, Lc={lc}, d={DIM}): {k3_ms:.4f} ms/call (runs {times['K3']}); plain version "
          f"{plain_ms:.4f} ms/call (runs {times['plain']}); {gbytes:.3f} GB moved -> {gbytes / k3_ms:.3f} TB/s, "
          f"{gbytes / k3_ms / 3.35:.3f} of 3.35 TB/s")
    lib_ms = k3_stock_ms(args, kern, gpu)

    for b in (1, 32):
        qb = originals[:b]
        route = index.resolve_union(b)
        p50, p90 = p50_ms(lambda: index.search_and_reconstruct(qb, TOPK), 30)
        print(f"  [{gpu}] search batch B={b} ({route} route, search_and_reconstruct k={TOPK}): p50 {p50:.3f} ms, "
              f"p90 {p90:.3f} ms (host clock, 30 batches)")
        busy = profile_search(index, qb)
        print(f"  [{gpu}] search batch B={b}: device busy {busy:.3f} ms per batch ({busy / p50:.3f} of the p50)")

    serial = itertools.count()
    text_query = lambda: knn(port, text=f"serial text query {next(serial)}")
    emb_query = lambda: knn(port, embedding_input=originals[next(serial) % N_QUERIES].tolist())

    for name, fn in (("text", text_query), ("embedding", emb_query)):
        p50, p90 = p50_ms(fn, 30)
        print(f"  [{gpu}] HTTP /knn-service serial {name} queries, k={TOPK}: p50 {p50:.2f} ms, p90 {p90:.2f} ms "
              f"(30 requests, host clock)")
    per_client = 16
    wall = concurrent_embedding_queries(port, originals, sample_ids, per_client=per_client)
    print(f"  [{gpu}] HTTP embedding queries, {CLIENTS} concurrent clients x {per_client}: "
          f"{CLIENTS * per_client / wall:.1f} QPS ({wall:.2f} s)")
    status, st = http_json(port, "POST", "/stage-times",
                           {"text_bucket": 16, "image_bucket": 16, "search_bucket": 64, "iters": 10, "k": TOPK})
    check(status == 200 and st["search"]["p50_ms"] > 0, f"/stage-times answered {status}: {st}")
    print(f"  [{gpu}] /stage-times (in-server p50, each call ends in its read-back): {json.dumps(st)}")
    status, summary = http_json(port, "GET", "/metrics-summary")
    check(status == 200, "/metrics-summary failed")
    print(f"  [{gpu}] /metrics-summary over every request of this run:\n{summary.decode()}")
    return k3_ms, plain_ms, err, 1e3 * gbytes * 1e9 / HBM_BPS, lib_ms


def k3_stock_ms(args, kern, gpu: str) -> float | None:
    """The stock PyTorch path to K3's function, timed beside K3 (not on the
    path): the chunks gathered (`index_select`), the int8 product by
    `torch._int_mm` (cuBLASLt, int32), then the scales and the padding mask,
    in the plain version's order.  Two library calls and two elementwise
    ones, so no single call; its output is held to K3's.  None where
    `_int_mm` refuses the shapes."""
    import torch

    qq, qs, rows, scales, pos, sel = args
    u, lc, d = sel.shape[0], rows.shape[1], rows.shape[2]
    s = sel.long()

    def stock():
        acc = torch._int_mm(qq, rows.index_select(0, s).view(u * lc, d).t())
        out = acc.float() * qs.float()[:, None] * scales.index_select(0, s).view(1, u * lc)
        return torch.where(pos.index_select(0, s).view(1, u * lc) >= 0, out, float("-inf"))

    try:
        got = stock()
    except RuntimeError as e:  # shapes or layouts the library does not take: reported, not on the path
        print(f"  [{gpu}] gather + torch._int_mm refused K3's served shape: {e}")
        return None
    ref = kern()
    torch.cuda.synchronize()
    check(torch.equal(torch.isneginf(got), torch.isneginf(ref)), "gather + _int_mm: -inf set differs from K3's")
    fin = torch.isfinite(ref)
    diff = (got[fin] - ref[fin]).abs().max().item()
    check(diff <= 1e-5, f"gather + _int_mm differs from K3 by {diff:.3e}")
    times = [cuda_ms(stock, 20) for _ in range(2)]
    print(f"  [{gpu}] yardstick gather (index_select) + torch._int_mm + scale/mask at the same shape: "
          f"{float(np.mean(times)):.4f} ms/call (runs {times}; two library calls, not one; max abs diff from K3 "
          f"{diff:.3e}; not on the path)")
    return float(np.mean(times))


def phase_pq_checks(pq_folder: str, pq_rows, pq_ids, pq_served, adc, gpu: str) -> dict:
    """The served IVF-PQ answers against an exact fp16 brute force on the
    card (recall@40), K4's device route against the host C++ scan (top-40
    overlap and scores), search-batch p50 at B=1 and B=32, and K4 against its
    plain version and `F.embedding_bag` at B=32 worklists and B=1 worklists
    with its bound.  Returns K4's numbers at the served worklist for the
    kernels line, with those at the B=1 worklists under `at_b1`."""
    from clip_retrieval_tpu_torch.index.flat import FlatIndex, to_device
    from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex, _device_room

    q = pq_rows[pq_ids].astype(np.float32)
    _, truth = FlatIndex(DIM, vectors=pq_rows, device="cuda").search(q, TOPK)
    recall = float(np.mean([len(set(s) & set(t.tolist())) / TOPK for s, t in zip(pq_served, truth)]))
    print(f"  [{gpu}] {PQ_INDEX}: recall@{TOPK} of the {len(pq_served)} served stored-row queries vs the exact fp16 "
          f"brute force on the card: {recall:.4f}")
    check(recall >= PQ_MIN_RECALL, f"IVF-PQ served recall@{TOPK} {recall:.4f} < {PQ_MIN_RECALL}")

    ix = IVFPQIndex.load(os.path.join(pq_folder, "image.index"), device="cuda")
    nprobe = min(ix.nprobe, ix.nlist)
    room = _device_room(ix.device)
    check(ix._fits_device(), "the IVF-PQ codes did not fit the card's free memory")
    print(f"  [{gpu}] {PQ_INDEX} codes image {ix._device_bytes() / 1e9:.3f} GB; the card's free memory less the "
          f"scan's reserve {room / 1e9:.2f} GB when staged: device route")
    dev_vals, dev_ids = ix._search_device(q, TOPK, nprobe)
    host_vals, host_ids = ix._search_host(q, TOPK, nprobe)
    overlaps, worst = [], 0.0
    for dv_, di, hv, hi in zip(dev_vals, dev_ids, host_vals, host_ids):
        shared = set(di.tolist()) & set(hi.tolist())
        overlaps.append(len(shared) / TOPK)
        d_of, h_of = dict(zip(di.tolist(), dv_.tolist())), dict(zip(hi.tolist(), hv.tolist()))
        worst = max([worst, *(abs(d_of[i] - h_of[i]) for i in shared)])
    print(f"  [{gpu}] {PQ_INDEX} ADC top-{TOPK} at nprobe {nprobe}, device (K4) vs host C++ scan: mean id overlap "
          f"{np.mean(overlaps):.4f} (min {min(overlaps):.4f}), shared ids' scores within {worst:.3e}")
    check(np.mean(overlaps) >= PQ_MIN_OVERLAP, f"device and host ADC overlap {np.mean(overlaps):.4f}")
    check(worst <= PQ_SCORE_TOL, f"device and host ADC scores differ by {worst:.3e}")

    for b in (1, 32):
        p50, p90 = p50_ms(lambda: ix.search_and_reconstruct(q[:b], TOPK), 30)
        print(f"  [{gpu}] {PQ_INDEX} search batch B={b} (search_and_reconstruct k={TOPK}, nprobe {nprobe}, "
              f"rerank_factor {ix.rerank_factor}): p50 {p50:.3f} ms, p90 {p90:.3f} ms (host clock, 30 batches)")
        busy = profile_search(ix, q[:b])
        print(f"  [{gpu}] {PQ_INDEX} search batch B={b}: device busy {busy:.3f} ms per batch ({busy / p50:.3f} of the p50)")

    # K4 at the B=32 worklist the device route gives this batch: at the served nprobe (the kernels line), and at
    # nprobe 64 and 256, worklists of the size a 1M-row index gives when its lists are probed widely; then at the
    # B=1 worklists of single-query searches (calibration and serial queries), nprobe 1, 8 and 32
    qr = to_device(q[:32], ix.device)
    if ix._ensure_device()["rotation"] is not None:
        qr = qr @ ix._ensure_device()["rotation"]
    timed = {np_: time_k4(ix, qr, np_, adc, gpu, "served" if np_ == nprobe else "wide")
             for np_ in sorted({nprobe, min(64, ix.nlist), min(256, ix.nlist)})}
    at_b1 = [{"nprobe": np_, **time_k4(ix, qr[:1], np_, adc, gpu, "single-query")}
             for np_ in (1, min(8, ix.nlist), min(32, ix.nlist))]
    worst = max(t["max_abs_err"] for t in [*timed.values(), *at_b1])
    return {**timed[nprobe], "max_abs_err": worst, "at_b1": at_b1}


def time_k4(ix, qr, nprobe: int, adc, gpu: str, label: str) -> dict:
    """K4 against its plain version (bit-identical, then timed in one call)
    at the chunk worklist the device route builds for the queries qr at
    nprobe, with its bound, beside `F.embedding_bag` over the same LUT
    (indices built before the timed region; not on the path).  Device times
    per call from CUDA graph replay (`ab_adc.graph_ms`), so the host's launch
    cost does not enter them.  Returns the numbers for the kernels line."""
    import torch

    from clip_retrieval_tpu_torch.tools.ab_adc import bag_check, bag_inputs, clock_max_hz, graph_ms, k4_bound
    from clip_retrieval_tpu_torch.tools.ab_adc import served_worklist

    args, route, nchunk_q = served_worklist(ix, qr, nprobe)
    err = check_k4(adc, args)
    idx, weight = bag_inputs(args)
    bag_err = bag_check(args, idx, weight)
    check(bag_err <= PQ_SCORE_TOL, f"embedding_bag's sums differ from the plain version's by {bag_err:.3e}")
    kern = lambda: adc.adc_scan(*args)
    plain = lambda: adc.adc_scan_reference(*args)
    bag = lambda: torch.nn.functional.embedding_bag(idx, weight, mode="sum")
    b1 = qr.shape[0] == 1
    iters = {"K4": 100 if b1 else 20, "plain": 10 if b1 else 2, "embedding_bag": 20 if b1 else 2}
    times: dict[str, list[float]] = {"K4": [], "plain": [], "embedding_bag": []}
    for name, fn in (("plain", plain), ("embedding_bag", bag), ("K4", kern), ("K4", kern), ("embedding_bag", bag),
                     ("plain", plain)):
        times[name].append(graph_ms(fn, iters[name]))
    k4_ms, plain_ms, bag_ms = (float(np.mean(times[n])) for n in ("K4", "plain", "embedding_bag"))
    del idx, weight
    torch.cuda.empty_cache()
    clock = clock_max_hz()
    bd = k4_bound(args, clock)
    print(f"  [{gpu}] K4 at the {label} B={qr.shape[0]} worklist, nprobe {nprobe} ({route}: {nchunk_q} chunks per "
          f"query, NC={bd['nc']}, {bd['valid_rows']} valid rows, M={ix.m}): {k4_ms:.4f} ms/call (runs {times['K4']}); "
          f"plain version {plain_ms:.4f} ms/call (runs {times['plain']}); F.embedding_bag {bag_ms:.4f} ms/call (runs "
          f"{times['embedding_bag']}, sums within {bag_err:.1e} of the plain version's; not on the path); bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: {bd['bytes'] / 1e6:.1f} MB at 3.35 TB/s = "
          f"{bd['bytes_ms']:.4f} ms, "
          f"{bd['lookups'] / 1e6:.1f} M LUT lookups at {SMS} SMs x 32/clk x {clock / 1e9:.3f} GHz = "
          f"{bd['lookups_ms']:.4f} ms); {k4_ms / bd['bound_ms']:.1f}x the bound; device times from CUDA graph replay")
    return {"nc": bd["nc"], "ms": k4_ms, "plain_ms": plain_ms, "library_ms": bag_ms, "max_abs_err": err,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"]}


# --------------------------------------------------------------------------
# slice 4: shard -> combine -> reorder -> serve, and the entry points on ported code
# --------------------------------------------------------------------------


def add_counts(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def folder_bytes(folder: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(folder) for f in files)


def same_rows(a, b, block: int = 1 << 17) -> bool:
    """Two (n, d) row stores (memmaps or ShardRowGathers) equal, read in blocks."""
    return a.shape == b.shape and all(np.array_equal(np.asarray(a[i : i + block]), np.asarray(b[i : i + block]))
                                      for i in range(0, a.shape[0], block))


def same_ids(a, b, q, where: str):
    """The ids of two indices' searches at B=1 (every query alone) and B=32."""
    for i in range(q.shape[0]):
        check(np.array_equal(a.search(q[i : i + 1], TOPK)[1], b.search(q[i : i + 1], TOPK)[1]),
              f"{where}: B=1 ids differ at query {i}")
    check(np.array_equal(a.search(q[:32], TOPK)[1], b.search(q[:32], TOPK)[1]), f"{where}: B=32 ids differ")


def phase_combine_pq(pq_folder: str, pq_rows, pq_ids, kernels: dict, gpu: str) -> dict:
    """The built pq1m index split by id range into COMBINE_SHARDS shard
    folders sharing its trained prefix (coarse centroids, rotation,
    codebooks; refine rows sliced by id range), merged by the
    `index_combiner` entry point on the card.  The merged arrays must equal
    pq1m's, and its B=1 and B=32 search ids pq1m's.  Returns the launch
    counts of the combine and the searches."""
    from clip_retrieval_tpu_torch.index.combiner import index_combiner
    from clip_retrieval_tpu_torch.index.ivfpq import IVFPQIndex

    t0 = time.perf_counter()
    whole = IVFPQIndex.load(os.path.join(pq_folder, "image.index"), device="cuda")
    ids, codes = np.asarray(whole.list_ids), np.asarray(whole.list_codes)
    list_of = np.repeat(np.arange(whole.nlist), whole.list_sizes())
    shards = os.path.join(WORK_DIR, "pq_shards")
    bounds = np.linspace(0, whole.ntotal, COMBINE_SHARDS + 1).astype(np.int64)
    for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        m = (ids >= lo) & (ids < hi)
        offsets = np.zeros(whole.nlist + 1, np.int64)
        np.cumsum(np.bincount(list_of[m], minlength=whole.nlist), out=offsets[1:])
        IVFPQIndex(whole.d, whole.coarse_centroids, whole.codebooks, whole.rotation, offsets, ids[m], codes[m],
                   nprobe=whole.nprobe, refine_vectors=whole.refine_vectors[lo:hi], rerank_factor=whole.rerank_factor,
                   device="cuda").save(os.path.join(shards, f"shard{s}"))
    t_split = time.perf_counter() - t0
    out = os.path.join(WORK_DIR, "pq_merged")
    zero_counts(kernels)
    t0 = time.perf_counter()
    merged = index_combiner(shards, out, device="cuda")
    wall = time.perf_counter() - t0
    written = folder_bytes(os.path.join(out, "populated.index"))
    check(np.array_equal(merged.list_offsets, whole.list_offsets), "merged list_offsets differ from pq1m's")
    check(np.array_equal(np.asarray(merged.list_ids), ids), "merged per-list ids differ from pq1m's")
    check(np.array_equal(np.asarray(merged.list_codes), codes), "merged codes differ from pq1m's")
    check(same_rows(merged.refine_vectors, whole.refine_vectors), "merged refine store differs from pq1m's")
    merged = IVFPQIndex.load(os.path.join(out, "populated.index"), device="cuda")
    same_ids(merged, whole, pq_rows[pq_ids].astype(np.float32), f"merged {PQ_INDEX}")
    counts = read_counts(kernels)
    check(counts["k4"] > 0, "K4 did not launch for the merged IVF-PQ index's searches")
    print(f"  [{gpu}] {PQ_INDEX} split into {COMBINE_SHARDS} shards by id range ({t_split:.1f} s), index_combiner "
          f"wall {wall:.2f} s, {written / 1e9:.3f} GB written; list_offsets, per-list ids, codes and the refine "
          f"store equal pq1m's; search ids identical at B=1 ({len(pq_ids)} queries) and B=32; launches {counts}")
    return counts


def phase_combine_int8_build(pq_corpus: str, pq_rows, gpu: str):
    """Over the pq1m corpus's rows: one coarse quantizer (nlist INT8_NLIST)
    trained on the card, COMBINE_SHARDS shard builds with
    `IVFInt8Index.from_vectors(..., coarse=, id_offset=)` and a
    whole-corpus build, then `index_combiner` over the shards into a folder
    served beside the other two (image.index + the corpus's metadata).
    Returns (the served folder, the whole build)."""
    from clip_retrieval_tpu_torch.index.combiner import index_combiner
    from clip_retrieval_tpu_torch.index.ivf_int8 import IVFInt8Index
    from clip_retrieval_tpu_torch.ops import kmeans

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    sample = pq_rows[np.sort(rng.choice(PQ_ROWS, 1 << 18, replace=False))].astype(np.float32)
    coarse = kmeans.kmeans(sample, INT8_NLIST, niter=20, seed=0, device="cuda").cpu().numpy()
    t_train = time.perf_counter() - t0
    shards = os.path.join(WORK_DIR, "int8_shards")
    bounds = np.linspace(0, PQ_ROWS, COMBINE_SHARDS + 1).astype(np.int64)
    t0 = time.perf_counter()
    for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        IVFInt8Index.from_vectors(pq_rows[lo:hi], nlist=INT8_NLIST, nprobe=NPROBE, coarse=coarse, id_offset=int(lo),
                                  device="cuda").save(os.path.join(shards, f"shard{s}"))
    t_shards = time.perf_counter() - t0
    whole = IVFInt8Index.from_vectors(pq_rows, nlist=INT8_NLIST, nprobe=NPROBE, coarse=coarse, device="cuda")
    folder = os.path.join(WORK_DIR, "int8_merged")
    t0 = time.perf_counter()
    index_combiner(shards, folder, device="cuda")
    wall = time.perf_counter() - t0
    written = folder_bytes(os.path.join(folder, "populated.index"))
    os.rename(os.path.join(folder, "populated.index"), os.path.join(folder, "image.index"))
    shutil.copytree(os.path.join(pq_corpus, "metadata"), os.path.join(folder, "metadata"))
    print(f"  [{gpu}] IVF-int8 over the {PQ_ROWS} x {DIM} corpus: coarse quantizer nlist {INT8_NLIST} trained in "
          f"{t_train:.1f} s, {COMBINE_SHARDS} shard builds in {t_shards:.1f} s, index_combiner wall {wall:.2f} s, "
          f"{written / 1e9:.3f} GB written; served as {INT8_INDEX}")
    return folder, whole


def phase_combine_int8(folder: str, whole, pq_rows, pq_ids, port: int, kernels: dict, gpu: str) -> dict:
    """The merged IVF-int8 index against the whole-corpus build: equal
    arrays, identical ids at B=1 and B=32 (K3 is bit-identical and every
    union route exact); `get_old_to_new_mapping` and `search_to_new_ids` on
    it; and the same answers from the running `back`, where it is the third
    index.  Returns the launch counts."""
    from clip_retrieval_tpu_torch.index.ivf_int8 import IVFInt8Index
    from clip_retrieval_tpu_torch.index.metadata_order import get_old_to_new_mapping, search_to_new_ids

    zero_counts(kernels)
    merged = IVFInt8Index.load(os.path.join(folder, "image.index"), device="cuda")
    for name in ("list_offsets", "list_ids", "q_vectors", "scales"):
        check(np.array_equal(np.asarray(getattr(merged, name)), np.asarray(getattr(whole, name))),
              f"merged IVF-int8 {name} differs from the whole build's")
    q = pq_rows[pq_ids].astype(np.float32)
    same_ids(merged, whole, q, "merged IVF-int8")
    t0 = time.perf_counter()
    mapping = get_old_to_new_mapping(merged)
    new_ids = search_to_new_ids(merged, q[:32], TOPK)
    _, old_ids = merged.search(q[:32], TOPK)
    check(np.array_equal(new_ids, mapping[old_ids]), "search_to_new_ids disagrees with the mapping")
    check(np.array_equal(np.sort(mapping), np.arange(merged.ntotal)), "the old->new mapping is not a permutation")
    t_map = time.perf_counter() - t0
    body = dict(deduplicate=False, use_safety_model=False, use_violence_detector=False)
    for i in range(8):
        res = knn(port, index=INT8_INDEX, embedding_input=q[i].tolist(), **body)
        check_results(res, f"{INT8_INDEX} embedding query {i}")
        check([r["id"] for r in res] == merged.search(q[i : i + 1], TOPK)[1][0].tolist(),
              f"{INT8_INDEX} served ids differ from the merged index's at query {i}")
    check_results(knn(port, index=INT8_INDEX, text="a photo of the query on the combined index"),
                  f"{INT8_INDEX} text query")
    counts = read_counts(kernels)
    check(counts["k3"] > 0, "K3 did not launch for the merged IVF-int8 index")
    print(f"  [{gpu}] {INT8_INDEX}: arrays equal the whole build's; search ids identical at B=1 ({len(pq_ids)} "
          f"queries) and B=32; old->new mapping and search_to_new_ids at B=32 in {t_map:.2f} s; served by clip_back "
          f"as a third index: 8 embedding queries answer the merged index's ids, a text query 200; launches {counts}")
    h5 = importlib.util.find_spec("h5py") is not None
    print(f"  reordered-hdf5 metadata provider (reorder_metadata_by_ivf_index): "
          f"{'h5py present' if h5 else 'h5py is absent on this machine, so it cannot run here'}; tier-1 tests hold "
          f"it to the JAX package on the CPU (tests/test_torch_metadata_order.py, tests/test_torch_serving.py)")
    return counts


def phase_surface(gpu: str):
    """The package-level API resolves to the port's own objects, and
    `resize_on_device` on the card over 32 seeded uint8 480x640 images to
    224 is held to the same call on the CPU (atol 2e-5) and timed with CUDA
    events."""
    import torch

    import clip_retrieval_tpu_torch as port
    from clip_retrieval_tpu_torch.models.preprocess import resize_on_device

    for name, (module, attr) in SURFACE_API.items():
        obj = getattr(port, name)
        check(obj is getattr(importlib.import_module(f"clip_retrieval_tpu_torch.{module}"), attr),
              f"clip_retrieval_tpu_torch.{name} is not {module}.{attr}")
    check(port.__version__ == "0.1.0", f"__version__ {port.__version__!r}")
    images = np.random.default_rng(21).integers(0, 256, (RESIZE_BATCH, *RESIZE_FROM, 3), dtype=np.uint8)
    on_card = resize_on_device(images, RESIZE_TO)  # a numpy array goes to the default device, the card
    check(on_card.device.type == "cuda" and on_card.dtype == torch.float32
          and tuple(on_card.shape) == (RESIZE_BATCH, RESIZE_TO, RESIZE_TO, 3), f"resize_on_device {on_card.shape}")
    err = (on_card.cpu() - resize_on_device(torch.from_numpy(images), RESIZE_TO)).abs().max().item()
    check(err <= RESIZE_ATOL, f"resize_on_device on the card vs the CPU: max abs {err:.3e} > {RESIZE_ATOL}")
    x = torch.from_numpy(images).cuda()
    for _ in range(3):
        resize_on_device(x, RESIZE_TO)
    ms = cuda_ms(lambda: resize_on_device(x, RESIZE_TO), 20)
    moved = images.nbytes + on_card.numel() * 4  # uint8 in read once, f32 out written once
    bound = moved / HBM_BPS * 1e3
    print(f"  [{gpu}] surface: {len(SURFACE_API)} top-level names and __version__ resolve to the port's objects; "
          f"resize_on_device {RESIZE_BATCH}x{RESIZE_FROM[0]}x{RESIZE_FROM[1]} uint8 -> {RESIZE_TO}: max abs vs the "
          f"CPU {err:.3e} (bar {RESIZE_ATOL}), {ms:.4f} ms on the card (CUDA events, 20 calls; byte bound "
          f"{bound:.4f} ms)")


def phase_arrow(pq_corpus: str, pq_ids, gpu: str):
    """`parquet_to_arrow` over the pq1m corpus's 1M-row metadata; the arrow
    provider's rows for the queried ids equal the parquet provider's."""
    from clip_retrieval_tpu_torch.back.metadata import ArrowMetadataProvider, ParquetMetadataProvider
    from clip_retrieval_tpu_torch.back.prepro import parquet_to_arrow

    meta, out = os.path.join(pq_corpus, "metadata"), os.path.join(WORK_DIR, "arrow")
    t0 = time.perf_counter()
    parquet_to_arrow(meta, out)
    wall = time.perf_counter() - t0
    arrow = ArrowMetadataProvider(out)
    ids = [int(i) for i in pq_ids]
    cols = ["image_path", "caption"]
    got, want = arrow.get(ids, cols), ParquetMetadataProvider(meta).get(ids, cols)
    check(arrow.table.num_rows == PQ_ROWS, f"arrow table has {arrow.table.num_rows} rows")
    check(got == want and got[0]["caption"] == f"row {ids[0]}", "arrow rows differ from the parquet provider's")
    print(f"  parquet_to_arrow over {PQ_ROWS} metadata rows: {wall:.2f} s, {folder_bytes(out) / 1e6:.1f} MB; the "
          f"arrow provider's rows for the {len(ids)} queried ids equal the parquet provider's")


def wsgi_json(app, method: str, path: str, body=None):
    """One in-process request to a WSGI app: (status, parsed JSON)."""
    raw = json.dumps(body).encode() if body is not None else b""
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "CONTENT_LENGTH": str(len(raw)),
               "wsgi.input": io.BytesIO(raw), "wsgi.errors": io.StringIO(), "wsgi.url_scheme": "http",
               "SERVER_NAME": "smoke", "SERVER_PORT": "80", "QUERY_STRING": ""}
    status = []
    data = b"".join(app(environ, lambda s, h, exc=None: status.append(s)))
    return status[0], json.loads(data)


def phase_end2end(kernels: dict, gpu: str) -> tuple[str, dict]:
    """`clip_end2end` over the main path's 512 JPEG+caption samples at
    ViT-L/14 (run_back=False): its embeddings, index and indices_paths.json
    load, K1 ran, and `clip_back`'s app serves the index (one text query).
    Returns (output folder, launch counts)."""
    import torch

    from clip_retrieval_tpu_torch import clip_end2end  # the package-level API, as a user calls it
    from clip_retrieval_tpu_torch.back.app import make_app
    from clip_retrieval_tpu_torch.back.options import ClipOptions
    from clip_retrieval_tpu_torch.back.resources import load_clip_indices

    out = os.path.join(WORK_DIR, "e2e")
    zero_counts(kernels)
    t0 = time.perf_counter()
    clip_end2end(input_dataset=f"{WORK_DIR}/corpus", input_format="files", clip_model=MODEL, run_back=False,
                 device="cuda", output_folder=out)
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    emb = np.load(os.path.join(out, "embeddings", "img_emb", "img_emb_0.npy"))
    check(emb.shape == (SAMPLES, DIM) and bool(np.isfinite(emb).all()), f"end2end embeddings {emb.shape}")
    with open(os.path.join(out, "index", "image.json")) as f:
        infos = json.load(f)
    with open(os.path.join(out, "indices_paths.json")) as f:
        paths = json.load(f)
    check(paths == {"example_index": os.path.join(out, "index")}, f"indices_paths.json holds {paths}")
    check(counts["k1"] == 2 * (24 + 12), f"K1 launched {counts['k1']} times in end2end's inference, expected 72")
    resources = load_clip_indices(os.path.join(out, "indices_paths.json"), ClipOptions(
        indice_folder="", clip_model=MODEL, columns_to_return=["image_path", "caption"],
        provide_aesthetic_embeddings=False, device="cuda"))
    app = make_app(resources, device="cuda")
    status, res = wsgi_json(app, "POST", "/knn-service", {"text": "a photo of sample number 7", "modality": "image",
                                                          "num_images": 10, "indice_name": "example_index"})
    check(status.startswith("200") and len(res) == 10 and all(r["caption"].startswith("a photo of sample number")
                                                                for r in res), f"end2end app answered {status}")
    counts = read_counts(kernels)
    del app, resources
    torch.cuda.empty_cache()
    print(f"  [{gpu}] clip_end2end over {SAMPLES} JPEG+caption samples at {MODEL} (run_back=False): wall {wall:.2f} s "
          f"(model init, inference, index build with recall); autotune chose {infos['index_key']!r}, recall@40 "
          f"{infos.get('recall@40')}; embeddings/, index/ and indices_paths.json load; clip_back's app served a text "
          f"query (10 results); launches {counts}")
    return out, counts


def recording_load_index(log: list):
    """A stand-in for `index.store.load_index` whose indices append every
    search / range_search output to `log` (the filter phase reads what
    `clip_filter` found from it)."""
    from clip_retrieval_tpu_torch.index import store

    real = store.load_index

    def load(*args, **kwargs):
        ix = real(*args, **kwargs)
        for name in ("search", "range_search"):
            fn = getattr(ix, name, None)
            if fn is not None:
                setattr(ix, name, lambda *a, _fn=fn, _n=name: log.append((_n, _fn(*a))) or log[-1][1])
        return ix

    return store, real, load


def phase_filter(e2e: str, pq_folder: str, kernels: dict, gpu: str) -> dict:
    """`clip_filter` on the end2end folder (a text query with a threshold,
    which takes range_search on a flat index; an image-file query) and on
    pq1m (a text query, num_results 40).  The files copied must be the
    files of the ids found.  Returns the launch counts."""
    from clip_retrieval_tpu_torch.filter import clip_filter

    log: list = []
    store, real, load = recording_load_index(log)
    store.load_index = load
    try:
        index = os.path.join(e2e, "index")
        with open(os.path.join(index, "image.index", "header.json")) as f:
            kind = json.load(f)["type"]
        text = "a photo of sample number 7"
        zero_counts(kernels)
        t0 = time.perf_counter()
        clip_filter(text, os.path.join(WORK_DIR, "f_probe"), index, num_results=SAMPLES, clip_model=MODEL,
                    device="cuda")
        threshold = float(np.median(log.pop()[1][0][0]))
        found = {}
        for name, query, kw in (("threshold", text, {"threshold": threshold}),
                                ("image", f"{WORK_DIR}/corpus/0007.jpg", {"num_results": 10})):
            out = os.path.join(WORK_DIR, f"f_{name}")
            clip_filter(query, out, index, clip_model=MODEL, device="cuda", **kw)
            op, res = log.pop()
            ids = res[2] if op == "range_search" else res[1][0][res[1][0] >= 0]
            check(sorted(os.listdir(out)) == sorted(f"{int(i):04d}.jpg" for i in ids) and 0 < len(ids) < SAMPLES,
                  f"filter {name}: copied {len(os.listdir(out))} files for {len(ids)} ids")
            found[name] = (op, len(ids), int(ids[0]))
        check(found["image"][2] == 7, f"the image query's first hit is {found['image'][2]}, not its own row")
        e2e_counts = read_counts(kernels)
        t_e2e = time.perf_counter() - t0
        clip_filter("a photo of the filter query on pq1m", os.path.join(WORK_DIR, "f_pq"), pq_folder, num_results=TOPK,
                    clip_model=MODEL, device="cuda")
        op, res = log.pop()
        check(op == "search" and int((res[1][0] >= 0).sum()) == TOPK, f"filter on {PQ_INDEX} found {res[1]}")
        counts = read_counts(kernels)
        pq_counts = {k: counts[k] - e2e_counts[k] for k in counts}
        check(e2e_counts["k1"] > 0 and pq_counts["k1"] > 0 and pq_counts["k4"] > 0,
              f"filter launches: end2end folder {e2e_counts}, {PQ_INDEX} {pq_counts}")
    finally:
        store.load_index = real
    print(f"  [{gpu}] clip_filter on the end2end folder ({kind} index): text query with threshold {threshold:.4f} "
          f"(the probe's median) -> {found['threshold'][0]}, {found['threshold'][1]} files copied; image-file query "
          f"-> {found['image'][1]} files, its own row first; 3 calls in {t_e2e:.1f} s; "
          f"launches {e2e_counts}; on {PQ_INDEX}: a text query, {TOPK} ids found (no image files there), launches "
          f"{pq_counts}")
    return counts


def phase_client(port: int, originals, gpu: str):
    """`ClipClient` (text, image file, embedding) against the running `back`:
    the same answers as a raw POST of the body it sends."""
    if importlib.util.find_spec("requests") is None:
        print("  client: requests is absent on this machine, so ClipClient cannot run here; tier-1 tests drive it "
              "over a socket (tests/test_torch_serving.py)")
        return
    from clip_retrieval_tpu_torch.client import ClipClient

    client = ClipClient(f"http://127.0.0.1:{port}/knn-service", indice_name=INDEX_NAME, num_images=TOPK,
                        deduplicate=False, use_safety_model=False, use_violence_detector=False)
    path = os.path.join(WORK_DIR, "client.jpg")
    with open(path, "wb") as f:
        f.write(base64.b64decode(jpeg_b64(21)))
    base = {"deduplicate": False, "use_safety_model": False, "use_violence_detector": False, "use_mclip": False,
            "aesthetic_score": 9, "aesthetic_weight": 0.5, "num_result_ids": TOPK}
    text, emb = {"text": "a photo of the client's query"}, {"embedding_input": originals[3].tolist()}
    for name, query, raw in (("text", text, text), ("image file", {"image": path}, {"image": jpeg_b64(21)}),
                             ("embedding", emb, emb)):
        got, want = client.query(**query), knn(port, **base, **raw)
        check([r["id"] for r in got] == [r["id"] for r in want], f"ClipClient {name} ids differ from raw HTTP")
        check(np.allclose([r["similarity"] for r in got], [r["similarity"] for r in want], atol=1e-5, rtol=0),
              f"ClipClient {name} similarities differ from raw HTTP")
    print(f"  [{gpu}] ClipClient text, image-file and embedding queries against clip_back: the raw HTTP answers "
          f"({TOPK} results each)")


def openai_rn_state_dict(cfg, seed: int) -> dict:
    """A whole openai-layout ModifiedResNet CLIP state dict at `cfg`'s full
    width on the CPU: random conv and linear weights, BatchNorms with random
    weight, bias, running mean and running variance (a fold that ignored one
    would show), an openai text tower (fused in_proj)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    sd = {}

    def conv_bn(conv: str, bn: str, cout: int, cin: int, k: int):
        sd[conv + ".weight"] = randn(cout, cin, k, k) * (k * k * cin) ** -0.5
        sd[bn + ".weight"] = 1 + 0.2 * randn(cout)
        sd[bn + ".bias"] = 0.2 * randn(cout)
        sd[bn + ".running_mean"] = 0.1 + 0.2 * randn(cout)
        sd[bn + ".running_var"] = 0.5 + torch.rand(cout, generator=gen, device="cuda")
        sd[bn + ".num_batches_tracked"] = torch.tensor(0)

    w = cfg.vision_width
    conv_bn("visual.conv1", "visual.bn1", w // 2, 3, 3)
    conv_bn("visual.conv2", "visual.bn2", w // 2, w // 2, 3)
    conv_bn("visual.conv3", "visual.bn3", w, w // 2, 3)
    cin = w
    for si, n_blocks in enumerate(cfg.resnet_layers):
        planes = w * 2 ** si
        for b in range(n_blocks):
            p = f"visual.layer{si + 1}.{b}."
            conv_bn(p + "conv1", p + "bn1", planes, cin, 1)
            conv_bn(p + "conv2", p + "bn2", planes, planes, 3)
            conv_bn(p + "conv3", p + "bn3", planes * 4, planes, 1)
            if b == 0:
                conv_bn(p + "downsample.0", p + "downsample.1", planes * 4, cin, 1)
            cin = planes * 4
    c, ap = cfg.attnpool_dim, "visual.attnpool."
    sd[ap + "positional_embedding"] = randn(cfg.grid_size ** 2 + 1, c) * c ** -0.5
    for proj, out in (("q_proj", c), ("k_proj", c), ("v_proj", c), ("c_proj", cfg.embed_dim)):
        sd[ap + proj + ".weight"] = randn(out, c) * c ** -0.5
        sd[ap + proj + ".bias"] = 0.02 * randn(out)
    tw = cfg.text_width
    sd["token_embedding.weight"] = 0.02 * randn(cfg.vocab_size, tw)
    sd["positional_embedding"] = 0.01 * randn(cfg.context_length, tw)
    for i in range(cfg.text_layers):
        p = f"transformer.resblocks.{i}."
        for key, rows, cols in ((p + "attn.in_proj_weight", 3 * tw, tw), (p + "attn.out_proj.weight", tw, tw),
                                (p + "mlp.c_fc.weight", 4 * tw, tw), (p + "mlp.c_proj.weight", tw, 4 * tw)):
            sd[key] = randn(rows, cols) * cols ** -0.5  # fan-in scale
            sd[key.replace("weight", "bias")] = torch.zeros(rows, device="cuda")
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = torch.ones(tw), torch.zeros(tw)
    sd["ln_final.weight"], sd["ln_final.bias"] = torch.ones(tw), torch.zeros(tw)
    sd["text_projection"] = randn(tw, cfg.embed_dim) * tw ** -0.5
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return {k: v.cpu() for k, v in sd.items()}


def phase_convert(kernels: dict, gpu: str) -> dict:
    """`convert` on an openai-layout RN50 state dict (.pt) with validation on
    the card; the npz loaded by `load_checkpoint`: its folded stem conv
    against conv → BatchNorm on the card (f32), and its bf16 image and text
    embeddings against its f32 plain ones (`rn_parity`).  Returns the launch
    counts."""
    import torch
    import torch.nn.functional as F

    from clip_retrieval_tpu_torch.models.configs import get_config
    from clip_retrieval_tpu_torch.models.convert import convert
    from clip_retrieval_tpu_torch.models.loaders import load_checkpoint
    from clip_retrieval_tpu_torch.models.tokenizer import CLIPTokenizer

    cfg = get_config(RN_MODEL)
    sd = openai_rn_state_dict(cfg, 12)
    pt, npz = os.path.join(WORK_DIR, "rn50_openai.pt"), os.path.join(WORK_DIR, "rn50_openai.npz")
    torch.save(sd, pt)
    zero_counts(kernels)
    t0 = time.perf_counter()
    check(convert(pt, npz, clip_model=RN_MODEL, device="cuda") == npz, "convert wrote another file")
    t_convert = time.perf_counter() - t0
    model, _ = load_checkpoint(npz, cfg, device="cuda")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, cfg.image_size, cfg.image_size, 3),
                                                                    dtype=np.float32)).cuda()
    bn = {k: sd[f"visual.bn1.{k}"].cuda() for k in ("weight", "bias", "running_mean", "running_var")}
    with torch.inference_mode():
        ref = F.batch_norm(F.conv2d(x.permute(0, 3, 1, 2), sd["visual.conv1.weight"].cuda(), stride=2, padding=1),
                           bn["running_mean"], bn["running_var"], bn["weight"], bn["bias"], eps=1e-5)
        got = model.visual.stem.conv1(x, stride=2, relu=False).permute(0, 3, 1, 2)
    fold_err = (got - ref).abs().max().item()
    print(f"  [{gpu}] convert of an openai-layout {RN_MODEL} state dict ({len(sd)} tensors, "
          f"{os.path.getsize(pt) / 1e6:.1f} MB) to npz and its validation on the card: {t_convert:.2f} s; folded stem "
          f"conv vs conv -> BatchNorm (f32): max abs {fold_err:.3e} (max |ref| {ref.abs().max().item():.3f})")
    check(fold_err <= 1e-4, f"the folded stem conv is off by {fold_err:.3e}")
    rn_parity(model, CLIPTokenizer.byte_fallback(), cfg, gpu, "the converted checkpoint")
    counts = read_counts(kernels)
    check(counts["k1"] == cfg.text_layers and counts["k3"] == counts["k4"] == 0,
          f"convert path launches {counts}, expected K1 {cfg.text_layers} (one bf16 text batch)")
    del model
    torch.cuda.empty_cache()
    return counts


class ByteTokenizer:
    """Stand-in for a `tokenizers.Tokenizer` where that package is missing:
    `.encode(text).ids` maps the UTF-8 bytes into the vocab between <s> = 0
    and </s> = 2."""

    class Encoding:
        def __init__(self, ids):
            self.ids = ids

    def encode(self, text: str):
        return self.Encoding([0] + [4 + b for b in text.encode("utf-8")] + [2])


def write_mclip_dir(folder: str, with_tokenizer: bool):
    """An M-CLIP checkpoint directory at XLM-R Large's published width
    (M-CLIP/XLM-Roberta-Large-Vit-L-14's text encoder) with random weights:
    config.json, pytorch_model.bin under HF XLMRobertaModel key names, and a
    sentence-transformers 2_Dense projection 1024 -> 768 (ViT-L/14's space);
    with `with_tokenizer`, a word-level tokenizer.json over the captions'
    words and digits."""
    import torch

    c = MCLIP_CONFIG
    h, f = c["hidden_size"], c["intermediate_size"]
    os.makedirs(os.path.join(folder, "2_Dense"))
    with open(os.path.join(folder, "config.json"), "w") as fp:
        json.dump(c, fp)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    randn = lambda *shape: (0.02 * torch.randn(*shape, generator=gen, device="cuda")).cpu()  # noqa: E731
    e = "embeddings."
    sd = {e + "word_embeddings.weight": randn(c["vocab_size"], h),
          e + "position_embeddings.weight": randn(c["max_position_embeddings"], h),
          e + "token_type_embeddings.weight": randn(c["type_vocab_size"], h),
          e + "LayerNorm.weight": torch.ones(h), e + "LayerNorm.bias": torch.zeros(h)}
    for i in range(c["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (f, h)), ("output.dense", (h, f))):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = randn(*shape), torch.zeros(shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = torch.ones(h), torch.zeros(h)
    torch.save(sd, os.path.join(folder, "pytorch_model.bin"))
    proj = torch.randn(DIM, h, generator=gen, device="cuda") * h ** -0.5
    torch.save({"linear.weight": proj.cpu(), "linear.bias": torch.zeros(DIM)},
               os.path.join(folder, "2_Dense", "pytorch_model.bin"))
    if with_tokenizer:
        from tokenizers import Tokenizer, models, pre_tokenizers, processors

        words = sorted({w for t in mclip_texts() for w in t.replace(",", " ").split() if not w.isdigit()})
        vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, **{w: 4 + i for i, w in enumerate([*words, *"0123456789",
                                                                                               ","])}}
        tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.Whitespace(),
                                                     pre_tokenizers.Digits(individual_digits=True)])
        tok.post_processor = processors.TemplateProcessing(single="<s> $A </s>", special_tokens=[("<s>", 0),
                                                                                               ("</s>", 2)])
        tok.save(os.path.join(folder, "tokenizer.json"))
    return sum(v.numel() for v in sd.values())


def mclip_texts() -> list:
    """The 512 captions of the corpus, in file order, and the queries."""
    caps = []
    for i in range(SAMPLES):
        with open(f"{WORK_DIR}/corpus/{i:04d}.txt") as f:
            caps.append(f.read())
    return caps + MCLIP_QUERIES


def phase_mclip(int8_folder: str, kernels: dict, gpu: str) -> dict:
    """The M-CLIP text tower at XLM-R Large's width: `load_mclip` on the card
    (timed, and held to the same model's f32 encode on the CPU), the encode
    of 1 and 32 texts timed, the mapper with `use_mclip` over the 512
    captions (text only; equal to the bundle's output), and `/knn-service`
    text queries with `use_mclip: true` against the merged IVF-int8 index
    through `make_app` in-process: 200 with num_images results, the ids of a
    direct search with the bundle's embedding, K3 launched and K1 not.
    Returns the launch counts of the mapper and the served queries."""
    import torch

    from clip_retrieval_tpu_torch.back.app import make_app
    from clip_retrieval_tpu_torch.back.options import ClipOptions
    from clip_retrieval_tpu_torch.back.resources import load_clip_indices
    from clip_retrieval_tpu_torch.inference.mapper import ClipMapper
    from clip_retrieval_tpu_torch.models.mclip import load_mclip

    folder = os.path.join(WORK_DIR, "mclip")
    has_tokenizers = importlib.util.find_spec("tokenizers") is not None
    t0 = time.perf_counter()
    n_params = write_mclip_dir(folder, with_tokenizer=has_tokenizers)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = load_mclip(folder, device="cuda")
    t_load = time.perf_counter() - t0
    cfg = bundle.cfg
    check((cfg.hidden, cfg.layers, cfg.heads, cfg.out_dim, cfg.position_offset) == (1024, 24, 16, DIM, 2),
          f"load_mclip read {cfg}")

    def tokenizer_for(b):
        if not has_tokenizers:
            b.tokenizer = ByteTokenizer()
        check(b.tokenizer is not None, "load_mclip loaded no tokenizer from tokenizer.json")

    tokenizer_for(bundle)
    print(f"  [{gpu}] M-CLIP at XLM-R Large width ({n_params / 1e6:.1f}M encoder parameters, vocab {cfg.vocab_size}, "
          f"hidden {cfg.hidden}, {cfg.layers} layers, {cfg.heads} heads, projection -> {cfg.out_dim}): written in "
          f"{t_write:.1f} s, load_mclip {t_load:.1f} s; tokenizer: "
          + ("tokenizer.json through the tokenizers package" if has_tokenizers else
             "the tokenizers package is absent on this machine, so the bundle was given the smoke's stand-in byte "
             "tokenizer (ids = UTF-8 bytes between <s> and </s>)"))
    texts = mclip_texts()
    caps, queries = texts[:SAMPLES], texts[SAMPLES:]
    got = bundle(queries)
    norms = np.linalg.norm(got.astype(np.float32), axis=-1)
    check(got.shape == (len(queries), DIM) and bool(np.isfinite(got).all()) and bool(np.all(np.abs(norms - 1) < 1e-2)),
          f"M-CLIP embeddings {got.shape}, norms {norms}")
    # the card against the CPU, f32, same model and ids
    encs = [bundle.tokenizer.encode(t).ids for t in queries]
    ids = np.full((len(encs), max(map(len, encs))), cfg.pad_token_id, np.int64)
    mask = np.zeros_like(ids)
    for i, e in enumerate(encs):
        ids[i, : len(e)], mask[i, : len(e)] = e, 1
    with torch.inference_mode():
        on_card = bundle.model.encode(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu()
        bundle.model.to("cpu")
        try:
            on_cpu = bundle.model.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        finally:
            bundle.model.to("cuda")
    cos = min_row_cos(on_card, on_cpu)
    check(cos >= 0.9999, f"M-CLIP on the card vs the CPU (f32): min cos {cos}")
    ms = {}
    for n in (1, 32):
        batch = (caps * 2)[:n]
        for _ in range(2):
            bundle(batch)
        t0 = time.perf_counter()
        for _ in range(10):
            bundle(batch)
        ms[n] = 1e3 * (time.perf_counter() - t0) / 10
    print(f"  [{gpu}] M-CLIP encode (f32, host clock incl. tokenizing and the fp16 read-back, 10 calls): 1 text "
          f"{ms[1]:.2f} ms, 32 texts {ms[32]:.2f} ms; card vs CPU f32 min cos {cos:.7f}")

    zero_counts(kernels)
    mapper = ClipMapper(enable_image=False, enable_text=True, clip_model=MODEL, use_mclip=True, mclip_model=folder,
                        batch_size=BATCH, device="cuda")
    tokenizer_for(mapper.mclip)
    t0 = time.perf_counter()
    embs = [mapper({"text": caps[i : i + BATCH]})["text_embs"] for i in range(0, SAMPLES, BATCH)]
    t_map = time.perf_counter() - t0
    embs = np.concatenate(embs)
    want = np.concatenate([bundle(caps[i : i + BATCH]) for i in range(0, SAMPLES, BATCH)])
    diff = float(np.abs(embs.astype(np.float32) - want.astype(np.float32)).max())
    check(embs.shape == (SAMPLES, DIM) and embs.dtype == np.float16 and diff <= 1e-3,
          f"the mapper's M-CLIP embeddings {embs.shape} differ from the bundle's by {diff}")
    mapper_counts = read_counts(kernels)
    check(mapper_counts["k1"] == mapper_counts["k2"] == mapper_counts["k3"] == mapper_counts["k4"] == 0
          and mapper_counts["epilogue"] > 0 and mapper_counts["layernorm"] > 0,
          f"the M-CLIP mapper launched {mapper_counts}: expected only the block's fused kernels (f32)")
    print(f"  [{gpu}] mapper with use_mclip over {SAMPLES} captions (2 batches of {BATCH}, text only): "
          f"{SAMPLES / t_map:.1f} captions/s, max abs vs the bundle {diff:.2e}; launches {mapper_counts}")
    del mapper
    torch.cuda.empty_cache()

    paths = os.path.join(WORK_DIR, "mclip_paths.json")
    with open(paths, "w") as f:
        json.dump({INT8_INDEX: int8_folder}, f)
    resources = load_clip_indices(paths, ClipOptions(
        indice_folder="", clip_model=MODEL, enable_mclip_option=True, mclip_model=folder,
        columns_to_return=["image_path", "caption"], provide_aesthetic_embeddings=False, device="cuda"))
    res = resources[INT8_INDEX]
    check(res.model_txt_mclip is not None, "back switched M-CLIP off (it failed to load)")
    tokenizer_for(res.model_txt_mclip)
    app = make_app(resources, device="cuda")
    body = dict(use_mclip=True, num_images=TOPK, indice_name=INT8_INDEX, modality="image", deduplicate=False,
                use_safety_model=False, use_violence_detector=False)
    zero_counts(kernels)
    served = []
    t0 = time.perf_counter()
    for q in queries:
        status, out = wsgi_json(app, "POST", "/knn-service", {"text": q, **body})
        check(status.startswith("200") and len(out) == TOPK, f"/knn-service use_mclip answered {status}: {out}")
        served.append([r["id"] for r in out])
    t_served = time.perf_counter() - t0
    served_counts = read_counts(kernels)
    check(served_counts["k3"] > 0 and served_counts["k1"] == 0, f"use_mclip queries launched {served_counts}")
    for q, ids in zip(queries, served):
        emb = res.model_txt_mclip(q).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        check(ids == res.image_index.search(emb, TOPK)[1][0].tolist(),
              f"served ids for {q!r} differ from a direct search with the bundle's embedding")
    print(f"  [{gpu}] /knn-service with use_mclip on {INT8_INDEX}: {len(queries)} multilingual text queries in "
          f"{t_served:.2f} s, {TOPK} results each, ids equal a direct search with the bundle's embedding; launches "
          f"{served_counts}")
    del app, resources, res, bundle
    torch.cuda.empty_cache()
    return add_counts(mapper_counts, served_counts)


def int8_product_err(index, q: np.ndarray, vals: np.ndarray, ids: np.ndarray) -> float:
    """Largest gap between the scores a search returned and the int8 product
    of each query and the row it names: the query quantized as the index
    quantizes it, the row's stored int8 values and scale, f32 in K3's order."""
    import torch

    from clip_retrieval_tpu_torch.ops.int8mm import quantize_rows_device

    qq, qs = quantize_rows_device(torch.from_numpy(q).cuda())
    qq, qs = qq.cpu().numpy().astype(np.int64), qs.cpu().numpy()
    pos = index._id_positions(ids.reshape(-1))
    rows = np.asarray(index.q_vectors[pos], np.int64).reshape(*ids.shape, -1)
    acc = np.einsum("bd,bkd->bk", qq, rows).astype(np.float32)
    want = acc * qs[:, None] * np.asarray(index.scales[pos], np.float32).reshape(ids.shape)
    return float(np.abs(vals - want).max())


def recall_at(ids, truth) -> float:
    return len(set(ids.tolist()) & set(truth.tolist())) / len(truth)


def phase_sharded_ivf(index, originals, truth, kernels: dict, gpu: str) -> tuple[dict, dict]:
    """`ShardedIVFInt8Index.from_index(<the served 10M index>, devices=
    ["cuda:0"] * 4)`: at B=1 (8 queries alone) and B=32, k=40, on the exact,
    device and static routes, K3 runs once per shard per batch (more only on
    a counted overflow re-dispatch), every score is the int8 product of the
    query and the row, and recall@40 against the exhaustive scan (`truth`)
    is at least the unsharded tier's on every query; at nprobe = nlist the
    ids equal the unsharded tier's.  Search-batch p50 beside the unsharded
    tier's.  Then `back` loads the index folder with `sharded_index` (every
    visible card) and answers embedding queries with a direct search's ids.
    Returns (launch counts of the path, p50 ms by tier, route and B)."""
    import torch

    from clip_retrieval_tpu_torch.back.app import make_app
    from clip_retrieval_tpu_torch.back.options import ClipOptions
    from clip_retrieval_tpu_torch.back.resources import load_clip_indices
    from clip_retrieval_tpu_torch.index.sharded_ivf import ShardedIVFInt8Index

    singles = [originals[i : i + 1] for i in range(8)]
    b32 = originals[:32]
    base1 = [index.search(q, TOPK)[1][0] for q in singles]
    base32 = index.search(b32, TOPK)[1]
    index.nprobe = NLIST
    full32 = index.search(b32, TOPK)[1]
    index.nprobe = NPROBE
    p50 = {("unsharded", index.resolve_union(b), b): p50_ms(lambda: index.search(originals[:b], TOPK), 30)[0]
           for b in (1, 32)}

    t0 = time.perf_counter()
    sharded = ShardedIVFInt8Index.from_index(index, devices=["cuda:0"] * SHARDS)
    sharded._ensure_device()
    torch.cuda.synchronize()
    shards = sharded._shards
    check(len(shards) == SHARDS and sum(sh["counts"].size for sh in shards) == NLIST,
          f"{len(shards)} shards hold {sum(sh['counts'].size for sh in shards)} lists")
    gb = sum(sh["img"]["rows"].numel() for sh in shards) / 1e9
    print(f"  [{gpu}] sharded IVF-int8: {SHARDS} shards on cuda:0 of {[sh['counts'].size for sh in shards]} lists, "
          f"{[sh['pad_chunk'] for sh in shards]} chunks, {gb:.3f} GB int8 in all; images built one shard at a time "
          f"in {time.perf_counter() - t0:.1f} s")

    zero_counts(kernels)
    for route in ("exact", "device", "static"):
        sharded.union = route
        worst_err, gains = 0.0, []
        for qb, rows, base in [(q, [i], base1[i][None]) for i, q in enumerate(singles)] + [(b32, range(32), base32)]:
            k3, redo = kernels["k3"].launches, sharded.overflow_redispatches
            vals, ids = sharded.search(qb, TOPK)
            launched = kernels["k3"].launches - k3
            check(launched == SHARDS * (1 + sharded.overflow_redispatches - redo),
                  f"{route} route, B={len(qb)}: K3 launched {launched} times for {SHARDS} shards")
            check(bool((ids >= 0).all()), f"{route} route: a query found fewer than {TOPK} rows")
            worst_err = max(worst_err, int8_product_err(index, qb, vals, ids))
            for j, row in enumerate(rows):
                got, want = recall_at(ids[j], truth[row]), recall_at(base[j], truth[row])
                check(got >= want, f"{route} route, B={len(qb)}, query {row}: recall@{TOPK} {got} < unsharded {want}")
                gains.append(got - want)
        check(worst_err <= 1e-6, f"{route} route: a score is {worst_err} off the int8 product")
        union = sharded.last_union_chunks  # of the B=32 batch at nprobe 64
        sharded.nprobe = NLIST
        check(np.array_equal(sharded.search(b32, TOPK)[1], full32),
              f"{route} route at nprobe = nlist: ids differ from the unsharded tier's")
        sharded.nprobe = NPROBE
        print(f"  {route} route: B=1 x 8 and B=32: K3 {SHARDS} launches a batch; scores = int8 products (max gap "
              f"{worst_err:.1e}); recall@{TOPK} vs the exhaustive scan >= unsharded on every query (mean gain "
              f"{np.mean(gains):.4f}); at nprobe {NLIST} the ids equal the unsharded tier's; B=32 union at nprobe "
              f"{NPROBE} {union} chunks on the largest shard, {sharded.overflow_redispatches} overflow re-dispatches "
              f"so far")
    for route in ("exact", "device", "static"):
        sharded.union = route
        for b in (1, 32):
            p50[("sharded", route, b)] = p50_ms(lambda: sharded.search(originals[:b], TOPK), 30)[0]
    counts = read_counts(kernels)
    print(f"  [{gpu}] search-batch p50 (ms, host clock, 30 batches of `search` k={TOPK}; all {SHARDS} shards on ONE "
          f"card, so this is the cost of the shard logic, not a speed-up): "
          + ", ".join(f"{t} {r} B={b}: {v:.3f}" for (t, r, b), v in p50.items()) + f"; launches {counts}")
    del sharded, shards
    torch.cuda.empty_cache()

    name = f"{INDEX_NAME}_sharded"
    paths = os.path.join(WORK_DIR, "sharded_paths.json")
    with open(paths, "w") as f:
        json.dump({name: {"indice_folder": os.path.join(WORK_DIR, "index"), "sharded_index": True}}, f)
    t0 = time.perf_counter()
    resources = load_clip_indices(paths, ClipOptions(
        indice_folder="", clip_model=MODEL, columns_to_return=["caption"], provide_aesthetic_embeddings=False,
        enable_faiss_memory_mapping=True, device="cuda"))
    served = resources[name].image_index
    check(isinstance(served, ShardedIVFInt8Index) and len(served.devices) == torch.cuda.device_count(),
          f"back loaded {type(served).__name__} over {getattr(served, 'devices', None)}")
    app = make_app(resources, device="cuda")
    body = dict(num_images=TOPK, indice_name=name, modality="image", deduplicate=False, use_safety_model=False,
                use_violence_detector=False)
    k3 = kernels["k3"].launches
    for i in range(4):
        status, out = wsgi_json(app, "POST", "/knn-service", {"embedding_input": originals[i].tolist(), **body})
        check(status.startswith("200") and len(out) == TOPK, f"sharded /knn-service answered {status}: {out}")
        check([r["id"] for r in out] == served.search(originals[i : i + 1], TOPK)[1][0].tolist(),
              f"sharded /knn-service ids differ from a direct search at query {i}")
    check(kernels["k3"].launches > k3, "K3 did not launch for the sharded /knn-service queries")
    print(f"  [{gpu}] back with sharded_index: {len(served.devices)} shard(s), one per visible card, loaded with "
          f"the model in {time.perf_counter() - t0:.1f} s; 4 /knn-service embedding queries answer a direct "
          f"search's ids; launches {read_counts(kernels)}")
    counts = read_counts(kernels)
    del app, resources, served
    torch.cuda.empty_cache()
    return counts, p50


def phase_sharded_flat(index, originals, sample_ids, kernels: dict, gpu: str) -> dict:
    """The 10M index's int8 rows as a `flat_int8` index on devices=["cuda:0"]
    * 4 and on ["cuda:0"]: equal ids at B=1 and B=32, each stored row found
    first (ids are row positions here), no kernel launched."""
    import torch

    from clip_retrieval_tpu_torch.index.sharded_flat import ShardedFlatIndex

    zero_counts(kernels)
    got, p50 = {}, {}
    for n in (SHARDS, 1):
        flat = ShardedFlatIndex(DIM, index.q_vectors, index.scales, devices=["cuda:0"] * n)
        got[n] = [flat.search(originals[i : i + 1], TOPK)[1][0] for i in range(8)] + [flat.search(originals[:32],
                                                                                                  TOPK)[1]]
        for b in (1, 32):
            p50[(n, b)] = p50_ms(lambda: flat.search(originals[:b], TOPK), 10)[0]
        del flat
        torch.cuda.empty_cache()
    for a, b in zip(got[SHARDS], got[1]):
        check(np.array_equal(a, b), "flat_int8 on 4 shards and on one device return different ids")
    first = np.asarray(index.list_ids)[got[1][-1][:, 0]]
    check(np.array_equal(first, sample_ids[:32]), "flat_int8 does not find each stored row first")
    counts = read_counts(kernels)
    check(not any(counts.values()), f"the flat_int8 tier launched a kernel: {counts}")
    print(f"  [{gpu}] sharded flat_int8 over the 10M int8 rows: {SHARDS} shards on cuda:0 and one device give equal "
          f"ids at B=1 (8 queries) and B=32, each stored row first; search p50 (ms, 10 batches) "
          + ", ".join(f"{n} shard(s) B={b}: {v:.2f}" for (n, b), v in p50.items()) + f"; launches {counts}")
    return counts


RANK_CODE = ("import sys\nfrom clip_retrieval_tpu_torch import cli\n"
             "from clip_retrieval_tpu_torch.ops import block_fused, flash\ncli.main(sys.argv[1:])\n"
             "print('K1_LAUNCHES', flash.flash_attention_packed.launches, block_fused.dense_epilogue.launches, "
             "block_fused.layernorm.launches, block_fused.rope_epilogue.launches, block_fused.glu_layernorm.launches, "
             "block_fused.dense_gemm.launches, flush=True)\n")


def phase_ranks(gpu: str) -> tuple[dict, dict]:
    """Batch inference by ranks, each its own process: two `inference
    --distribution_strategy pod` ranks (RANK 0/1, WORLD_SIZE 2, LOCAL_RANK 0:
    two hosts of one card each) and two `inference.slurm_worker` ranks
    (SLURM_PROCID 0/1, SLURM_NTASKS 2, SLURM_LOCALID 0, as srun sets them) over
    the main path's 512 samples at ViT-L/14 bf16 in 4 partitions, beside one
    sequential process writing the same 4 partitions.  Each rank's partitions
    must equal the sequential ones bit for bit; each rank prints its K1
    launches.  Returns the launch counts of the pod and the slurm ranks."""
    from clip_retrieval_tpu_torch.inference.slurm import SlurmDistributor

    corpus = f"{WORK_DIR}/corpus"
    common = ["--clip_model", MODEL, "--batch_size", str(BATCH), "--num_prepro_workers", "2", "--device", "cuda"]

    def inference(out: str, strategy: str) -> list:
        return ["inference", "--input_dataset", corpus, "--output_folder", out, "--output_partition_count",
                str(RANK_PARTITIONS), "--distribution_strategy", strategy, *common]

    args = {"input_dataset": corpus, "output_folder": f"{WORK_DIR}/slurm", "output_partition_count": RANK_PARTITIONS,
            "batch_size": BATCH, "num_prepro_workers": 2, "clip_model": MODEL, "device": "cuda",
            "slurm_cache_path": f"{WORK_DIR}/slurm_cache"}
    args_path, sbatch = SlurmDistributor(list(range(RANK_PARTITIONS)), args)._write_inputs()
    with open(sbatch) as f:
        script = f.read()
    check("--ntasks-per-node=8" in script and "clip_retrieval_tpu_torch.inference.slurm_worker" in script,
          "the sbatch script does not ask for one task per GPU running the port's rank entry")
    runs = {"sequential": (inference(f"{WORK_DIR}/sequential", "sequential"), {})}
    for r in range(2):
        runs[f"pod{r}"] = (inference(f"{WORK_DIR}/pod", "pod"), {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0"})
        runs[f"slurm{r}"] = (["inference.slurm_worker", "--worker_args_path", args_path],
                             {"SLURM_PROCID": str(r), "SLURM_NTASKS": "2", "SLURM_LOCALID": "0"})
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "SLURM_PROCID", "SLURM_NTASKS")}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-c", RANK_CODE, *argv], env={**base, **env},
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (argv, env) in runs.items()}
    logs = {}
    try:
        for name, p in procs.items():
            logs[name] = p.communicate(timeout=600)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    k1, fused = {}, {}
    for name, p in procs.items():
        check(p.returncode == 0, f"rank process {name} exited {p.returncode}:\n{logs[name][-3000:]}")
        lines = [ln for ln in logs[name].splitlines() if ln.startswith("K1_LAUNCHES")]
        check(len(lines) == 1, f"rank process {name} printed no K1 count")
        k1[name], *fused[name] = map(int, lines[0].split()[1:])
    per_rank = RANK_PARTITIONS // 2 * (24 + 12)  # 2 partitions of 128 samples, one batch each, per rank
    for name in ("pod0", "pod1", "slurm0", "slurm1"):
        check(k1[name] == per_rank, f"{name} launched K1 {k1[name]} times, expected {per_rank}")
    for out in ("pod", "slurm"):
        for kind in ("img_emb", "text_emb"):
            for i in range(RANK_PARTITIONS):
                got = np.load(f"{WORK_DIR}/{out}/{kind}/{kind}_{i}.npy")
                want = np.load(f"{WORK_DIR}/sequential/{kind}/{kind}_{i}.npy")
                check(got.shape == (SAMPLES // RANK_PARTITIONS, DIM) and np.array_equal(got, want),
                      f"{out} {kind} partition {i} differs from the sequential run's")
    print(f"  [{gpu}] ranks: 2 pod ranks and 2 slurm_worker ranks (each one process, this card) and one sequential "
          f"process, {RANK_PARTITIONS} partitions of {SAMPLES // RANK_PARTITIONS} samples at {MODEL} bf16: every "
          f"rank's partitions equal the sequential ones bit for bit; K1 launches by process {k1}; wall {wall:.1f} s "
          f"for the five processes at once (start, model init, decode, inference)")
    def path(a: str, b: str) -> dict:
        return {"k1": k1[a] + k1[b], "k2": 0, "k3": 0, "k4": 0, "epilogue": fused[a][0] + fused[b][0],
                "layernorm": fused[a][1] + fused[b][1], "rope": fused[a][2] + fused[b][2],
                "glu": fused[a][3] + fused[b][3], "gemm": fused[a][4] + fused[b][4]}

    return path("pod0", "pod1"), path("slurm0", "slurm1")


def phase_train(kernels: dict, gpu: str) -> dict:
    """`make_train_step` at ViT-B/32 (full width and depth, f32) on a world
    of one nccl rank, 5 steps of batch 128: finite losses, the last below the
    first, step 1's loss equal to the plain `clip_forward` + loss of the same
    init on the CPU (rtol 1e-3; TF32 is off for the whole smoke, so the f32
    products are f32); ms per step and peak memory; one bf16 step finite; no
    kernel launched (attention takes the plain route)."""
    import datetime

    import torch
    import torch.distributed as dist

    from clip_retrieval_tpu_torch.models.clip import clip_forward, init_clip
    from clip_retrieval_tpu_torch.models.configs import get_config
    from clip_retrieval_tpu_torch.parallel.train import clip_contrastive_loss, make_train_step

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the CPU comparison")
    cfg = get_config(TRAIN_MODEL)
    rng = np.random.default_rng(21)
    images = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, cfg.image_size, cfg.image_size, 3), dtype=np.uint8))
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, (TRAIN_BATCH, cfg.context_length)).astype(np.int32))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    try:
        zero_counts(kernels)
        base = torch.cuda.memory_allocated()  # what the earlier phases still hold
        init_fn, train_step = make_train_step(cfg, device="cuda")
        params, opt = init_fn(0)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = train_step(params, opt, images, tokens)
            losses.append(float(loss))
            ms.append(1e3 * (time.perf_counter() - t0))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        init16, step16 = make_train_step(cfg, compute_dtype=torch.bfloat16, device="cuda")
        p16, o16 = init16(0)
        loss16 = float(step16(p16, o16, images, tokens)[2])
        counts = read_counts(kernels)
    finally:
        dist.destroy_process_group()
    del params, opt, p16, o16
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"losses {losses}")
    check(math.isfinite(loss16), f"bf16 step loss {loss16}")
    check(not any(counts.values()), f"the train step launched a kernel: {counts}")
    t0 = time.perf_counter()
    cpu = init_clip(cfg, 0, device="cpu")
    with torch.no_grad():
        loss_cpu = float(clip_contrastive_loss(*clip_forward(cpu, images, tokens, attn_impl="xla")))
    rel = abs(losses[0] - loss_cpu) / abs(loss_cpu)
    check(rel <= 1e-3, f"step 1 loss {losses[0]} on the card vs {loss_cpu} on the CPU (rel {rel:.2e})")
    print(f"  [{gpu}] train step {TRAIN_MODEL} f32, batch {TRAIN_BATCH}, world of 1 on nccl (dp=1, tp=1): losses "
          f"{[round(x, 5) for x in losses]}; ms per step {[round(x, 1) for x in ms]} (host clock, step 1 includes "
          f"first calls), peak {peak:.2f} GiB over what earlier phases hold (weights, AdamW state, activations); "
          f"step 1 vs the CPU's plain forward of the same init: {loss_cpu:.6f}, rel "
          f"{rel:.1e} (TF32 off; CPU forward {time.perf_counter() - t0:.1f} s); one bf16 step loss {loss16:.5f}; "
          f"launches {counts}")
    return counts


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if importlib.util.find_spec("clip_retrieval_tpu_torch") is None:
        print("chip_smoke: run it from the root of a checkout (clip_retrieval_tpu_torch not found)", file=sys.stderr)
        return 2
    from clip_retrieval_tpu_torch.inference.mapper import ClipMapper
    from clip_retrieval_tpu_torch.native import get_adc_lib
    from clip_retrieval_tpu_torch.ops import adc_scan, block_fused, cuda_build, flash, int8scan

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32, the f32 int8 product exact
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"k1": flash.flash_attention_packed, "k2": flash.flash_attention, "k3": int8scan.int8_gather_scan,
               "k4": adc_scan.adc_scan, "epilogue": block_fused.dense_epilogue, "layernorm": block_fused.layernorm,
               "rope": block_fused.rope_epilogue, "glu": block_fused.glu_layernorm, "gemm": block_fused.dense_gemm}

    phase = "device"
    try:
        kind = torch.cuda.get_device_name(0)
        gpu = card_line()
        print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
        print(gpu)

        phase = "build"
        t0 = time.perf_counter()
        build_s = cuda_build.build_all()
        print(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in build_s.items())} (nvcc, then load; in parallel), "
              f"{time.perf_counter() - t0:.2f} s in all")
        t0 = time.perf_counter()
        check(get_adc_lib() is not None, "the host C++ ADC scanner (native/adc_scan.cpp) did not build")
        print(f"build: host ADC scanner (g++) {time.perf_counter() - t0:.2f} s")

        phase = "K1 vs plain"
        max_abs = phase_kernels(flash)

        phase = "K3 vs plain"
        k3_err = phase_k3(int8scan)

        phase = "K2 vs plain"
        k2_err = phase_k2(flash)

        phase = "K4 vs plain"
        k4_err = phase_k4(adc_scan)

        phase = "block fused vs plain"
        fused = phase_block_fused(block_fused, gpu)

        phase = "EVA02 fused vs plain"
        eva_fused = phase_eva_fused(block_fused, gpu)

        phase = "dense GEMM vs plain"
        gemm = phase_dense_gemm(block_fused, gpu)

        phase = "main path"
        inference_counts = phase_main_path(kernels, gpu)

        phase = "EVA02 main path"
        eva_counts = phase_main_path(kernels, gpu, EVA_MODEL)

        mapper = ClipMapper(enable_image=True, enable_text=True, clip_model=MODEL, batch_size=BATCH, device="cuda")
        phase = "tower parity"
        phase_parity(mapper, gpu)

        phase = "times"
        (k1_ms, plain_ms, sdpa_ms), k1_text, k1_siglip, k1_eva, max_abs_b256 = phase_times(flash, mapper, gpu)
        del mapper
        torch.cuda.empty_cache()

        phase = "sdpa path"
        sdpa_counts, k2_ms, k2_plain_ms, k2_lib_ms, k2_err_path = phase_sdpa(flash, kernels, gpu)

        phase = "K1 at the ResNet text shapes"
        gen_rn = torch.Generator(device="cuda")
        gen_rn.manual_seed(8)
        k1_rn_text = {heads: time_k1(flash, gen_rn, 77, heads, 64, True, gpu) for heads in (8, 16)}

        phase = "RN50 main path"
        t0 = time.perf_counter()
        rn_counts = phase_rn_main_path(kernels, gpu)
        print(f"  phase 'RN50 main path' wall {time.perf_counter() - t0:.1f} s")

        phase = "RN tower parity"
        t0 = time.perf_counter()
        rn_rates, rn_shares = phase_rn_towers(gpu)
        print(f"  phase 'RN tower parity' wall {time.perf_counter() - t0:.1f} s")

        phase = "convert"
        t0 = time.perf_counter()
        convert_counts = phase_convert(kernels, gpu)
        print(f"  phase 'convert' wall {time.perf_counter() - t0:.1f} s")

        phase = "index build"
        corpus, pq_rows = phase_pq_corpus(gpu)
        pq_folder, index_counts = phase_pq_build(corpus, kernels, gpu)
        pq_ids = np.sort(np.random.default_rng(11).choice(PQ_ROWS, N_QUERIES, replace=False))
        pq_probed = phase_pq_probe(pq_folder, pq_rows, pq_ids, gpu)

        phase = "combine, IVF-int8 build"
        t0 = time.perf_counter()
        int8_folder, int8_whole = phase_combine_int8_build(corpus, pq_rows, gpu)
        print(f"  phase 'combine, IVF-int8 build' wall {time.perf_counter() - t0:.1f} s")

        phase = "index"
        index, sample_ids, originals = phase_index(gpu, {PQ_INDEX: pq_folder, INT8_INDEX: int8_folder})

        phase = "served path"
        served_counts, served, pq_served = phase_serve(kernels, sample_ids, originals, pq_rows, pq_ids, pq_probed,
                                                       gpu)

        phase = "recall"
        truth = phase_recall(index, int8scan, originals, served)

        phase = "query times"
        k3_ms, k3_plain_ms, k3_err_served, k3_bound, k3_lib_ms = phase_query_times(
            index, int8scan, originals, sample_ids, served_counts["port"], gpu
        )

        phase = "IVF-PQ checks"
        k4 = phase_pq_checks(pq_folder, pq_rows, pq_ids, pq_served, adc_scan, gpu)

        phase = "combine, IVF-PQ"
        t0 = time.perf_counter()
        combine_counts = phase_combine_pq(pq_folder, pq_rows, pq_ids, kernels, gpu)
        print(f"  phase 'combine, IVF-PQ' wall {time.perf_counter() - t0:.1f} s")

        phase = "combine, IVF-int8"
        t0 = time.perf_counter()
        combine_counts = add_counts(combine_counts, phase_combine_int8(
            int8_folder, int8_whole, pq_rows, pq_ids, served_counts["port"], kernels, gpu))
        del int8_whole
        print(f"  phase 'combine, IVF-int8' wall {time.perf_counter() - t0:.1f} s")

        phase = "arrow"
        t0 = time.perf_counter()
        phase_arrow(corpus, pq_ids, gpu)
        print(f"  phase 'arrow' wall {time.perf_counter() - t0:.1f} s")

        phase = "surface"
        t0 = time.perf_counter()
        phase_surface(gpu)
        print(f"  phase 'surface' wall {time.perf_counter() - t0:.1f} s")

        phase = "end2end"
        t0 = time.perf_counter()
        e2e_folder, e2e_counts = phase_end2end(kernels, gpu)
        print(f"  phase 'end2end' wall {time.perf_counter() - t0:.1f} s")

        phase = "filter"
        t0 = time.perf_counter()
        filter_counts = phase_filter(e2e_folder, pq_folder, kernels, gpu)
        print(f"  phase 'filter' wall {time.perf_counter() - t0:.1f} s")

        phase = "client"
        t0 = time.perf_counter()
        phase_client(served_counts["port"], originals, gpu)
        print(f"  phase 'client' wall {time.perf_counter() - t0:.1f} s")

        phase = "mclip"
        t0 = time.perf_counter()
        mclip_counts = phase_mclip(int8_folder, kernels, gpu)
        print(f"  phase 'mclip' wall {time.perf_counter() - t0:.1f} s")

        phase = "pod and slurm_worker ranks"
        t0 = time.perf_counter()
        pod_counts, slurm_counts = phase_ranks(gpu)
        print(f"  phase 'pod and slurm_worker ranks' wall {time.perf_counter() - t0:.1f} s")

        phase = "sharded IVF-int8"
        t0 = time.perf_counter()
        sharded_counts, sharded_p50 = phase_sharded_ivf(index, originals, truth, kernels, gpu)
        print(f"  phase 'sharded IVF-int8' wall {time.perf_counter() - t0:.1f} s")

        phase = "sharded flat_int8"
        t0 = time.perf_counter()
        flat_counts = phase_sharded_flat(index, originals, sample_ids, kernels, gpu)
        print(f"  phase 'sharded flat_int8' wall {time.perf_counter() - t0:.1f} s")

        phase = "train"
        t0 = time.perf_counter()
        train_counts = phase_train(kernels, gpu)
        print(f"  phase 'train' wall {time.perf_counter() - t0:.1f} s")

        phase = "kernels line"
        paths = {"inference": inference_counts, "inference_eva": eva_counts, "index": index_counts, "serving": served_counts, "sdpa": sdpa_counts,
                 "combine": combine_counts, "end2end": e2e_counts, "filter": filter_counts,
                 "inference_rn50": rn_counts, "convert": convert_counts, "mclip": mclip_counts, "pod": pod_counts,
                 "slurm_worker": slurm_counts, "sharded_ivf": sharded_counts, "sharded_flat": flat_counts,
                 "train": train_counts}

        def by_path(key: str) -> dict:
            return {name: counts[key] for name, counts in paths.items()}

        att_bound, att_by = attention_bound_ms(BATCH, 16, 257, 257, 64, 2)
        rows = [
            ("k1", "flash_attention_packed", "flash_packed.cu", "clip_retrieval_tpu/ops/flash.py:191",
             max(max_abs, max_abs_b256), k1_ms, plain_ms, att_bound, att_by, sdpa_ms),
            ("k2", "flash_attention", "flash_packed.cu", "clip_retrieval_tpu/ops/flash.py:259",
             max(k2_err, k2_err_path), k2_ms, k2_plain_ms, att_bound, att_by, k2_lib_ms),
            ("k3", "int8_gather_scan", "int8_scan.cu", "clip_retrieval_tpu/ops/int8scan.py:130",
             max(k3_err, k3_err_served), k3_ms, k3_plain_ms, k3_bound, "bytes", k3_lib_ms),
            ("k4", "adc_scan", "adc_scan.cu", "clip_retrieval_tpu/ops/adc_scan.py:81",
             max(k4_err, k4["max_abs_err"]), k4["ms"], k4["plain_ms"], k4["bound_ms"], k4["bound_by"],
             k4["library_ms"]),
        ]
        for key, name in (("epilogue", "dense_epilogue"), ("layernorm", "layernorm")):
            siglip = fused[key]["towers"]["siglip image"]
            rows.append((key, name, "block_fused.cu", "none: XLA fuses these ops on the TPU",
                         fused[key]["max_abs_err"], siglip["ms"], siglip["plain_ms"], siglip["bound_ms"], "bytes",
                         None))
        for key, name in (("rope", "rope_epilogue"), ("glu", "glu_layernorm")):
            e = eva_fused[key]
            rows.append((key, name, "block_fused.cu", "none: the JAX package has no EVA02", e["max_abs_err"],
                         e["ms"], e["plain_ms"], e["bound_ms"], "bytes", None))
        rows.append(("gemm", "dense_gemm", "dense_gemm.cu", "none: XLA fuses the epilogue into the TPU's matmul",
                     gemm["max_abs_err"], gemm["ms"], gemm["plain_ms"], gemm["bound_ms"], "flops",
                     gemm["library_ms"]))
        line = []
        for key, name, src, replaces, err, ms, p_ms, bound, by, lib in rows:
            launches = by_path(key)
            check(sum(launches.values()) > 0, f"{name} never launched on a path")
            line.append({"name": name, "route": "cuda", "source": f"clip_retrieval_tpu_torch/csrc/{src}",
                         "replaces": replaces, "launches": sum(launches.values()), "launches_by_path": launches,
                         "max_abs_err": err, "ms": ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                         "library_ms": lib})
        text_bound, _ = attention_bound_ms(BATCH, 12, 77, 77, 64, 2)
        line[0]["at_text_shape"] = {"shape": [BATCH, 77, 12, 64], "causal": True, "ms": k1_text[0],
                                    "plain_ms": k1_text[1], "library_ms": k1_text[2], "bound_ms": text_bound}
        line[0]["at_siglip_image_shape"] = {
            "shape": [BATCH, 729, 16, 72], "causal": False, "route": "wgmma", "ms": k1_siglip[0],
            "plain_ms": k1_siglip[1], "library_ms": k1_siglip[2],
            "bound_ms": attention_bound_ms(BATCH, 16, 729, 729, 72, 2)[0]}
        line[0]["at_eva_image_shape"] = {
            "shape": [BATCH, 577, 16, 64], "causal": False, "route": "wgmma", "ms": k1_eva[0],
            "plain_ms": k1_eva[1], "library_ms": k1_eva[2],
            "bound_ms": attention_bound_ms(BATCH, 16, 577, 577, 64, 2)[0]}
        line[0]["at_rn_text_shapes"] = [
            {"shape": [BATCH, 77, heads, 64], "causal": True, "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
             "max_abs_err": t[3], "bound_ms": attention_bound_ms(BATCH, heads, 77, 77, 64, 2)[0]}
            for heads, t in k1_rn_text.items()]
        line[0]["max_abs_err"] = max(line[0]["max_abs_err"], *(t[3] for t in k1_rn_text.values()))
        print(f"  RN50 / RN50x64 img/s: {rn_rates}; RN50 image tower device-time shares: {rn_shares}")
        line[3]["at_b1"] = k4["at_b1"]  # single-query worklists: nearly all of K4's launches
        for row, key in ((line[4], "epilogue"), (line[5], "layernorm")):  # ms etc.: one SigLIP image block's calls
            row["per_block_by_tower"] = fused[key]["towers"]
        line[2]["sharded_search_p50_ms"] = {f"{t} {r} B={b}": v for (t, r, b), v in sharded_p50.items()}
    except Exception as e:  # every phase failure ends the run with its phase named
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)

    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    code = run()
    sys.stdout.flush()
    sys.stderr.flush()
    # the server and micro-batcher threads are daemons that hold CUDA work;
    # end the process without the interpreter's teardown racing them
    os._exit(code)

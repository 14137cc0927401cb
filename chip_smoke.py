#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`.  It builds every
CUDA kernel of the embedding path from `clip_retrieval_tpu_torch/csrc/`,
checks each against its plain PyTorch version on the card, drives the
port's inference entry point end to end at ViT-L/14 (full width, random
weights from `init_clip`, bf16, batch 256, image and text towers), checks
the embeddings, compares the bf16 kernel path with the f32 plain path on the
same weights, and times the mapper and the kernel.

Phases, each of which stops the script with a non-zero exit when it fails:
device, build, kernel vs plain, main path, tower parity, times.  The line
before the last is a JSON object describing each kernel; the last line is
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

BATCH = 256
SAMPLES = 512
MODEL = "ViT-L/14"
# (heads, dh, S, causal): every attention geometry of the supported towers
GEOMETRIES = [(12, 64, 50, False), (16, 64, 257, False), (16, 80, 257, False), (16, 88, 257, False),
              (16, 64, 577, False), (12, 64, 77, True)]
BF16_MAX_ABS, BF16_MIN_COS, F32_MAX_ABS = 2e-2, 0.9999, 1e-4
TOWER_MIN_COS = 0.999  # tests/test_models/test_clip_parity.py:101-102
WORK_DIR = os.path.join("build", "chip_smoke")


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


def check_k1(flash, q, k, v, heads: int, causal: bool) -> float:
    """One K1 call against its plain version (f32, same inputs); fails on a
    miss of the bars and returns the max abs error."""
    import torch

    b, s, w = q.shape
    dh = w // heads
    got = flash.flash_attention_packed(q, k, v, heads, causal=causal)
    ref = flash.flash_attention_packed_reference(q.float(), k.float(), v.float(), heads, causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    cos = min_row_cos(got.reshape(-1, dh), ref.reshape(-1, dh))
    finite = bool(torch.isfinite(got).all())
    where = f"{str(q.dtype).split('.')[-1]} B={b} heads={heads} dh={dh} S={s} causal={causal}"
    print(f"  K1 {where}: max_abs={err:.3e} min_cos={cos:.7f} finite={finite}")
    check(finite, f"K1 non-finite output at {where}")
    if q.dtype == torch.bfloat16:
        check(err <= BF16_MAX_ABS and cos >= BF16_MIN_COS, f"K1 bf16 off at {where}")
    else:
        check(err <= F32_MAX_ABS, f"K1 f32 off at {where}")
    return err


def phase_kernels(flash) -> float:
    """K1 against its plain version on the card at every tower geometry,
    B=4; returns the worst bf16 max abs error."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst_bf16 = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for heads, dh, s, causal in GEOMETRIES:
            q, k, v = (torch.randn(4, s, heads * dh, generator=gen, device="cuda").to(dtype) for _ in range(3))
            err = check_k1(flash, q, k, v, heads, causal)
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
    return worst_bf16


def write_corpus(folder: str):
    from PIL import Image

    os.makedirs(folder)
    rng = np.random.default_rng(0)
    for i in range(SAMPLES):
        h, w = (240, 320) if i % 2 else (300, 260)  # both orientations exercise resize + crop
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(f"{folder}/{i:04d}.jpg", quality=90)
        with open(f"{folder}/{i:04d}.txt", "w") as f:
            f.write(f"a photo of sample number {i}, seed {int(rng.integers(1 << 20))}")


def phase_main_path(flash, gpu: str) -> int:
    """The `inference` entry point over 512 JPEG+caption samples at
    ViT-L/14 bf16 b256; returns K1's launch count in that run."""
    from clip_retrieval_tpu_torch.inference.main import main as clip_inference

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    corpus, out = f"{WORK_DIR}/corpus", f"{WORK_DIR}/out"
    check(importlib.util.find_spec("PIL") is not None, "PIL is needed to write and decode the JPEG corpus")
    for mod in ("pandas", "pyarrow"):
        check(importlib.util.find_spec(mod) is not None, f"{mod} is needed to write the parquet metadata")
    write_corpus(corpus)
    flash.flash_attention_packed.launches = 0
    t0 = time.perf_counter()
    clip_inference(
        input_dataset=corpus, output_folder=out, batch_size=BATCH, num_prepro_workers=8, clip_model=MODEL,
        device="cuda",
    )
    wall = time.perf_counter() - t0
    launches = flash.flash_attention_packed.launches
    print(f"  [{gpu}] main path wall {wall:.2f} s on the host clock, 2 batches, including model init and "
          f"JPEG decode; K1 launches {launches}")
    for sub, name in (("img_emb", "img_emb_0.npy"), ("text_emb", "text_emb_0.npy")):
        emb = np.load(f"{out}/{sub}/{name}")
        norms = np.linalg.norm(emb.astype(np.float32), axis=-1)
        print(f"  {sub}: shape={emb.shape} dtype={emb.dtype} norm range [{norms.min():.5f}, {norms.max():.5f}]")
        check(emb.shape == (SAMPLES, 768) and emb.dtype == np.float16, f"{sub} has shape {emb.shape} {emb.dtype}")
        check(bool(np.isfinite(emb).all()), f"{sub} has non-finite values")
        check(bool(np.all(np.abs(norms - 1) <= 1e-2)), f"{sub} norms leave 1 ± 1e-2")
    import pandas as pd

    meta = pd.read_parquet(f"{out}/metadata/metadata_0.parquet")
    check(len(meta) == SAMPLES and list(meta.columns) == ["image_path", "caption"], "bad parquet metadata")
    with open(f"{out}/stats/0.json") as f:
        stats = json.load(f)
    check(stats.get("sample_count") == SAMPLES, f"stats count {stats.get('sample_count')}")
    expected = 2 * (24 + 12)  # 2 batches x (vision + text layers)
    check(launches == expected, f"K1 launched {launches} times on the main path, expected {expected}")
    return launches


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


def phase_times(flash, mapper, gpu: str) -> tuple[float, float, float]:
    """Mapper samples/s on device-resident inputs, and K1 against its plain
    version at the main path's two attention shapes in bf16: checked against
    the plain version's output with the bars of phase_kernels, then timed.
    Returns (K1 ms, plain ms) at the image tower's (256, 257, 16x64) and the
    worst max abs error of the two checks."""
    import torch
    import torch.nn.functional as F

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
    results, worst = [], 0.0
    # the two attention shapes of the main path: image tower, then causal text tower
    for s, heads, dh, causal in ((257, 16, 64, False), (77, 12, 64, True)):
        q, k, v = (torch.randn(BATCH, s, heads * dh, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        worst = max(worst, check_k1(flash, q, k, v, heads, causal))
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
        print(f"  [{gpu}] K1 ({BATCH}, {s}, {heads}x{dh}{', causal' if causal else ''}) bf16: {k1_ms:.4f} ms/call "
              f"(runs {times['K1']}); plain version {plain_ms:.4f} ms/call (runs {times['plain']}); yardstick "
              f"F.scaled_dot_product_attention on (B,H,S,dh) {sdpa_ms:.4f} ms/call (not on the path)")
        results.append((k1_ms, plain_ms))
    return (*results[0], worst)


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if importlib.util.find_spec("clip_retrieval_tpu_torch") is None:
        print("chip_smoke: run it from the root of a checkout (clip_retrieval_tpu_torch not found)", file=sys.stderr)
        return 2
    from clip_retrieval_tpu_torch.inference.mapper import ClipMapper
    from clip_retrieval_tpu_torch.ops import flash

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False

    phase = "device"
    try:
        kind = torch.cuda.get_device_name(0)
        gpu = card_line()
        print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
        print(gpu)

        phase = "build"
        t0 = time.perf_counter()
        flash.build()
        print(f"build: flash_packed (nvcc, then load) in {time.perf_counter() - t0:.2f} s")

        phase = "kernel vs plain"
        max_abs = phase_kernels(flash)

        phase = "main path"
        launches = phase_main_path(flash, gpu)

        mapper = ClipMapper(enable_image=True, enable_text=True, clip_model=MODEL, batch_size=BATCH, device="cuda")
        phase = "tower parity"
        phase_parity(mapper, gpu)

        phase = "times"
        k1_ms, plain_ms, max_abs_b256 = phase_times(flash, mapper, gpu)
    except Exception as e:  # every phase failure ends the run with its phase named
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)

    kernels = [{
        "name": "flash_attention_packed",
        "route": "cuda",
        "source": "clip_retrieval_tpu_torch/csrc/flash_packed.cu",
        "replaces": "clip_retrieval_tpu/ops/flash.py:191",
        "launches": launches,
        "max_abs_err": max(max_abs, max_abs_b256),
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())

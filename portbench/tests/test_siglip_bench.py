"""CPU tests of the SigLIP cell's benchmark files: the seeded weights have
`transformers.SiglipModel`'s keys and shapes, the FLOP counter matches a
hand count at the published widths, the two metric readers read synthetic
contexts (and nothing where the program has no span), the cell resolves,
and its driver rehearses end to end at a tiny size: correct, with the fp8
control and a planted fault not correct, and a program without the
configuration refused in set-up before the corpus is built.

Run from the root of a checkout: `python -m pytest portbench/tests -q`."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PB))
sys.path.insert(1, str(PB.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench import siglip_flops, siglip_weights, spec  # noqa: E402
from bench.trace import DeviceTrace  # noqa: E402

CELL = "embed.siglip-so400m-384.jpeg384"
DATA = PB / "tests" / "data"
PUBLISHED = json.loads((PB / "configs" / "siglip-so400m-14-384.json").read_text())
TINY = json.loads((DATA / "tiny-siglip.json").read_text())


def test_seeded_weights_have_siglipmodels_keys_and_shapes():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    from transformers import SiglipConfig, SiglipModel

    c = TINY
    hc = SiglipConfig(
        text_config=dict(vocab_size=c["vocab_size"], hidden_size=c["text_width"], intermediate_size=c["text_mlp_dim"],
                         num_hidden_layers=c["text_layers"], num_attention_heads=c["text_heads"],
                         max_position_embeddings=c["context_length"], projection_size=c["embed_dim"]),
        vision_config=dict(image_size=c["image_size"], patch_size=c["patch_size"], hidden_size=c["vision_width"],
                           intermediate_size=c["vision_mlp_dim"], num_hidden_layers=c["vision_layers"],
                           num_attention_heads=c["vision_heads"]))
    want = {k: tuple(v.shape) for k, v in SiglipModel(hc).state_dict().items()}
    sd = siglip_weights.make_state_dict(c, 5, "cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    # the shapes alone, at the published widths: 878 M parameters
    n = sum(__import__("math").prod(s) for _, s, _ in siglip_weights.state_dict_shapes(PUBLISHED))
    assert 877e6 < n < 879e6


def test_flops_by_hand_at_the_published_widths():
    w, m, n, layers, s = 1152, 4304, 27 * 27, 27, 64
    block = lambda t: 2 * t * (4 * w * w + 2 * w * m) + 4 * t * t * w  # noqa: E731
    head = 2 * n * 2 * w * w + 2 * w * w + 4 * n * w + 2 * w * w + 2 * 2 * w * m
    img = 2 * n * 14 * 14 * 3 * w + layers * block(n) + head
    txt = layers * block(s) + 2 * w * w
    assert siglip_flops.image_tower(PUBLISHED) == img
    assert siglip_flops.text_tower(PUBLISHED) == txt
    assert 723.0e9 < img + txt < 724.0e9  # ~4.1x ViT-L/14's 175 GFLOP a pair
    assert 670e9 < img < 671e9 and 53.0e9 < txt < 53.2e9


def _trace(names_ms):
    ops, t = [], 0.0
    for name, ms in names_ms:
        ops.append((t, t + ms * 1e3, name))
        t += ms * 1e3 + 1e3  # 1 ms idle between operations
    return DeviceTrace(window_s=t * 1e-6, ops=ops, runtime=[])


def test_k1_busy_share_on_a_synthetic_trace():
    read = spec.metric_reader("embed.k1_busy_share").read
    tr = _trace([("flash_mma_kernel<80>", 3.0), ("void flash_bf16_kernel<80, true>(...)", 3.0),
                 ("nvjet_gemm", 10.0), ("flash_wgmma_kernel", 1.0), ("Memcpy HtoD", 3.0)])
    assert read({"trace": tr}) == pytest.approx(100.0 * 4.0 / 20.0)
    assert read({"trace": _trace([("nvjet_gemm", 1.0)])}) is None  # no K1 launch
    assert read({"trace": None}) is None


def _spans(tokens_per_batch, batches=3):
    out = [{"name": "runner.partition", "id": 1, "parent": None, "batch": None, "start_ns": 0, "end_ns": 1,
            "counters": {}}]
    for b in range(batches):
        out.append({"name": "runner.batch", "id": 10 + b, "parent": 1, "batch": b + 1, "start_ns": 0, "end_ns": 1,
                    "counters": {}})
        if tokens_per_batch:
            out.append({"name": "mapper.image", "id": 20 + b, "parent": 30 + b, "batch": b + 1, "start_ns": 0,
                        "end_ns": 1, "counters": {"tokens": tokens_per_batch}})
    return out


def test_image_tokens_per_s_on_synthetic_spans():
    read = spec.metric_reader("embed.image_tokens_per_s").read
    ctx = {"run": {"batches": 2, "window_s": 0.5}, "spans": _spans(256 * 729)}
    assert read(ctx) == pytest.approx(2 * 256 * 729 / 0.5)  # the last 2 of 3 batches are the window's
    assert read({"run": {"batches": 2, "window_s": 0.5}, "spans": _spans(0)}) is None  # a program without the span
    assert read({"run": {"batches": 2, "window_s": 0.5}, "spans": None}) is None


def test_the_cell_resolves_with_its_metrics():
    c = spec.resolve(CELL)
    assert c.traffic["driver"] == "embed_siglip" and c.config["program_model"] == "ViT-SO400M-14-SigLIP-384"
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "embed_samples_per_s"]
    names = {m["name"] for m in c.per_layer}
    assert {"embed.k1_busy_share", "embed.image_tokens_per_s", "k1_roofline.embed", "embed_mfu",
            "device_idle.embed"} <= names
    assert c.traffic["window_rate_cap"] >= 600 and c.traffic["image"]["size"] == c.config["image_size"] == 384
    drv = spec.driver("embed_siglip")
    assert drv.program_config(c.config).name == "ViT-SO400M-14-SigLIP-384"


def _tiny_cell(**overrides):
    c = spec.resolve(CELL)
    c.config = dict(TINY)
    c.traffic = json.loads((DATA / "tiny-jpeg.json").read_text())
    c.traffic.update({"driver": "embed_siglip", "image": {**c.traffic["image"], "size": TINY["image_size"]}},
                     **overrides)
    return c


def _execute(cell, tmp_path, trace=False, controls=()):
    import torch

    import run

    return run.execute(cell, 2**31 + 9, 0.6, trace, torch.device("cpu"), str(tmp_path), controls=controls)


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_is_correct_and_carries_the_metrics(trace, tmp_path):
    cell = _tiny_cell()
    result, checks = _execute(cell, tmp_path, trace=trace,
                              controls=() if trace else ({"image_precision": "fp8", "text_precision": "fp8"},))
    assert result["correct"] is True, checks
    assert result["attempted"] > 0 and result["failed"] == 0
    got = {k: m["value"] for k, m in result["metrics"].items()}
    if trace:
        from bench import peaks

        c = cell.config
        # the window's full batches: image rows a second = samples a second, each of grid² tokens
        samples_per_s = got["embed_mfu"] / 100 * peaks.BF16_FLOPS / (siglip_flops.image_tower(c)
                                                                      + siglip_flops.text_tower(c))
        grid = c["image_size"] // c["patch_size"]
        assert got["embed.image_tokens_per_s"] == pytest.approx(samples_per_s * grid * grid, rel=1e-9)
        assert "embed.k1_busy_share" not in got  # no device trace on the CPU
    else:
        assert set(got) == {"setup_s", "embed_samples_per_s"}
        ctl = result["notes"]["controls"][0]["checks"]
        assert any(v["value"] > v["limit"] for v in ctl.values()), ctl


def test_a_planted_fault_is_not_correct(monkeypatch, tmp_path):
    from clip_retrieval_tpu_torch.inference import mapper

    orig = mapper.tclip.encode_text
    monkeypatch.setattr(mapper.tclip, "encode_text", lambda *a, **k: orig(*a, **k).roll(1, dims=0))
    result, checks = _execute(_tiny_cell(check_rows=10**6), tmp_path)
    assert result["correct"] is False and checks["txt_gap"]["value"] > checks["txt_gap"]["limit"], checks


def test_a_program_without_the_configuration_fails_in_setup(monkeypatch, tmp_path):
    """Before the corpus is built: the parent of this cell has no
    `ViT-SO400M-14-SigLIP-384`."""
    import torch

    cell = _tiny_cell()
    cell.config["program_model"] = "no-such-model"
    built = []
    drv_mod = spec.driver("embed_siglip")
    monkeypatch.setattr(drv_mod.corpus_mod, "build", lambda *a, **k: built.append(1))
    with pytest.raises(KeyError):
        drv_mod.Driver(cell, 1, torch.device("cpu"), str(tmp_path)).setup()
    assert not built

"""CPU tests of the EVA02 cell's benchmark files: the cell resolves with its
metrics, the configuration's keys are held to the port's, the FLOP counter
gives ~395 GFLOP a sample at the published widths, the two new kernels'
bounds count the bytes by hand, their roofline readers read synthetic
traces (and nothing where the program has no kernel), and the embed_eva
harness module rehearses end to end at a tiny size: correct, with the fp8 control and a
planted fault not correct, and a program without the configuration refused
in set-up before the corpus is built.

Run from the root of a checkout: `python -m pytest portbench/tests -q`."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PB))
sys.path.insert(1, str(PB.parent))

from bench import eva_flops, eva_weights, peaks, spec  # noqa: E402
from bench.recorder import KernelRecorder  # noqa: E402
from bench.trace import DeviceTrace  # noqa: E402

CELL = "embed.eva02-l-14-336.jpeg384crop"
DATA = PB / "tests" / "data"
PUBLISHED = json.loads((PB / "configs" / "eva02-l-14-336.json").read_text())
TINY = json.loads((DATA / "tiny-eva.json").read_text())


def test_the_cell_resolves_with_its_metrics():
    c = spec.resolve(CELL)
    assert c.traffic["driver"] == "embed_eva" and c.config["program_model"] == "EVA02-L-14-336"
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "embed_samples_per_s"]
    names = {m["name"] for m in c.per_layer}
    assert len(names) == 16 and {"rope_roofline.embed", "glu_roofline.embed", "k1_roofline.embed", "embed_mfu",
                                 "embed.fused_share"} <= names
    assert c.traffic["image"]["size"] == 384 and c.config["image_size"] == 336
    assert c.limits["rows_wrong"]["max"] == 0
    for other in ("embed.vit-l-14.jpeg", "embed.siglip-so400m-384.jpeg384"):
        assert not {"rope_roofline.embed", "glu_roofline.embed"} & {m["name"] for m in spec.resolve(other).per_layer}


@pytest.mark.parametrize("cfg", [PUBLISHED, TINY], ids=["published", "tiny"])
def test_the_configuration_is_held_to_the_ports(cfg):
    """Every key of the file that the port's configuration has is equal there;
    `program_config` raises a ValueError that names a key that differs."""
    from clip_retrieval_tpu_torch.models import configs

    pcfg = spec.driver("embed_eva").program_config(cfg)
    assert pcfg is configs.get_config(cfg["program_model"])
    for key, value in cfg.items():
        if key != "name" and hasattr(pcfg, key):
            ours = getattr(pcfg, key)
            assert (list(ours) if isinstance(ours, tuple) else ours) == value, key
    with pytest.raises(ValueError, match="rope_grid"):
        spec.driver("embed_eva").program_config({**cfg, "rope_grid": 7})


def test_flops_by_hand_at_the_published_widths():
    """24 × (2·577·(4·1024² + 3·1024·2730) + 4·577²·1024) + the patches and
    the head ≈ 381.9 GFLOP, the text tower 13.2: ≈ 395 GFLOP a sample."""
    w, h, n = 1024, 2730, 577
    img = 2 * 576 * 14 * 14 * 3 * w + 24 * (2 * n * (4 * w * w + 3 * w * h) + 4 * n * n * w) + 2 * w * 768
    assert eva_flops.image_tower(PUBLISHED) == img
    assert 13.1e9 < eva_flops.text_tower(PUBLISHED) < 13.3e9
    assert 394.5e9 < img + eva_flops.text_tower(PUBLISHED) < 395.5e9
    # the hidden is counted at the model's 2730, whatever the program pads
    assert eva_flops.image_tower({**PUBLISHED, "vision_mlp_dim": 2736}) > img


def test_seeded_weights_have_the_open_clip_keys_and_load():
    """The tiny state dict has the keys and shapes the port's converter reads
    (every one of them), with 428 M parameters at the published widths."""
    import torch

    from clip_retrieval_tpu_torch.models import clip as tclip
    from clip_retrieval_tpu_torch.models import configs, loaders

    sd = eva_weights.make_state_dict(TINY, 5, "cpu")
    read = set()

    class Reads(dict):
        def __getitem__(self, key):
            read.add(key)
            return super().__getitem__(key)

    model = loaders.convert_eva_state_dict(Reads(sd), configs.get_config("test-tiny-eva"), "cpu")
    assert read == set(sd)
    assert not any(k.endswith("k_proj.bias") for k in sd)
    assert torch.equal(model.visual.proj_bias, sd["visual.trunk.head.bias"])
    n = sum(math.prod(s) for _, s, _ in eva_weights.state_dict_shapes(PUBLISHED))
    assert 428.0e6 < n < 428.2e6
    assert n + 24 * 1024 == tclip.count_params(tclip.CLIP(configs.get_config("EVA02-L-14-336"), device="meta"))


def test_kernel_bounds_by_hand():
    """At the cell's shapes: the rotary epilogue moves 6 bytes an element of
    (256·577, 1024) plus bias and table (~0.27 ms at 3.35 TB/s); the gate
    10 bytes a hidden element of (256·577, 2730) (~1.20 ms)."""
    import torch

    rope, glu = spec.kernel("rope"), spec.kernel("glu")
    rows = 256 * 577
    shape = rope.shape_of((torch.zeros(256, 577, 1024), torch.zeros(1024), torch.zeros(2, 576, 32)),
                          {"prefix": 1, "dtype": torch.bfloat16})
    assert shape == (rows, 1024, 576, 64, True, 2)
    assert rope.bytes_moved(*shape) == rows * 1024 * 6 + 4 * 1024 + 4 * 576 * 64
    assert 0.26e-3 < rope.bound_s(shape) < 0.28e-3
    gshape = glu.shape_of((torch.zeros(2, 3, 2 * 2736), torch.zeros(2 * 2736), torch.zeros(2730), torch.zeros(2730),
                           1e-6), {"dtype": torch.bfloat16})
    assert gshape == (6, 2730, True, 2)
    assert glu.bytes_moved(rows, 2730, True, 2) == rows * 2730 * 10 + 8 * 2730 + 8 * 2730
    assert 1.19e-3 < glu.bound_s((rows, 2730, True, 2)) < 1.21e-3
    assert glu.bound_s((rows, 2730, True, 2)) == glu.bytes_moved(rows, 2730, True, 2) / peaks.HBM_BYTES_PER_S


def _trace(names_ms):
    ops, t = [], 0.0
    for name, ms in names_ms:
        ops.append((t, t + ms * 1e3, name))
        t += ms * 1e3 + 1e3
    return DeviceTrace(window_s=t * 1e-6, ops=ops, runtime=[])


@pytest.mark.parametrize("kernel,device_name", [
    ("rope", "void (anonymous namespace)::rope_epilogue_kernel<__nv_bfloat16>(float const*, ...)"),
    ("glu", "void (anonymous namespace)::glu_layernorm_kernel<__nv_bfloat16, 12>(float const*, ...)"),
])
def test_roofline_readers_on_a_synthetic_trace(kernel, device_name):
    """Each launch recorded through the wrapper is matched to one device
    kernel of its name; the share is Σ bound ÷ device time.  No launch or no
    trace: None."""
    read = spec.metric_reader(f"{kernel}_roofline.embed").read
    rec = KernelRecorder(spec.kernel(kernel))
    try:
        rec.shapes = [(1000, 64, 8, 8, True, 2)] if kernel == "rope" else [(1000, 42, True, 2)]
        tr = _trace([(device_name, 0.01), ("dense_epilogue_kernel", 1.0), ("layernorm_kernel", 1.0)])
        want = 100.0 * rec.bound_s() / 1e-5
        assert read({"trace": tr, "kernels": {kernel: rec}}) == pytest.approx(want)
        assert read({"trace": _trace([("nvjet_gemm", 1.0)]), "kernels": {kernel: rec}}) is None
        assert read({"trace": None, "kernels": {kernel: rec}}) is None
        rec.shapes = []
        assert read({"trace": tr, "kernels": {kernel: rec}}) is None
    finally:
        rec.restore()


def _tiny_cell(**overrides):
    c = spec.resolve(CELL)
    c.config = dict(TINY)
    c.traffic = json.loads((DATA / "tiny-jpeg.json").read_text())
    c.traffic.update({"driver": "embed_eva"}, **overrides)
    return c


def _execute(cell, tmp_path, trace=False, controls=()):
    import torch

    import run

    return run.execute(cell, 2**31 + 13, 0.6, trace, torch.device("cpu"), str(tmp_path), controls=controls)


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_is_correct_and_carries_the_metrics(trace, tmp_path):
    """72 px JPEGs cropped to 40 through `test-tiny-eva`: correct; the fp8
    control fails a limit; traced, MFU and tokens/s agree with EVA02's FLOPs
    and 26 tokens an image, and the CPU run has no device trace to read."""
    cell = _tiny_cell()
    result, checks = _execute(cell, tmp_path, trace=trace,
                              controls=() if trace else ({"image_precision": "fp8", "text_precision": "fp8"},))
    assert result["correct"] is True, checks
    assert result["attempted"] > 0 and result["failed"] == 0
    got = {k: m["value"] for k, m in result["metrics"].items()}
    if trace:
        c = cell.config
        samples_per_s = got["embed_mfu"] / 100 * peaks.BF16_FLOPS / (eva_flops.image_tower(c)
                                                                      + eva_flops.text_tower(c))
        assert got["embed.image_tokens_per_s"] == pytest.approx(samples_per_s * 26, rel=1e-9)
        assert "rope_roofline.embed" not in got and "glu_roofline.embed" not in got  # no device trace on the CPU
    else:
        assert set(got) == {"setup_s", "embed_samples_per_s"}
        ctl = result["notes"]["controls"][0]["checks"]
        assert any(v["value"] > v["limit"] for v in ctl.values()), ctl


def test_a_planted_fault_is_not_correct(monkeypatch, tmp_path):
    from clip_retrieval_tpu_torch.inference import mapper

    orig = mapper.tclip.encode_image
    monkeypatch.setattr(mapper.tclip, "encode_image", lambda *a, **k: orig(*a, **k).roll(1, dims=0))
    result, checks = _execute(_tiny_cell(check_rows=10**6), tmp_path)
    assert result["correct"] is False and checks["img_gap"]["value"] > checks["img_gap"]["limit"], checks


def test_a_program_without_the_configuration_fails_in_setup(monkeypatch, tmp_path):
    """Before the corpus is built: the parent of this cell has no
    `EVA02-L-14-336`."""
    import torch

    cell = _tiny_cell()
    cell.config["program_model"] = "no-such-model"
    built = []
    drv_mod = spec.driver("embed_eva")
    monkeypatch.setattr(drv_mod.corpus_mod, "build", lambda *a, **k: built.append(1))
    with pytest.raises(KeyError):
        drv_mod.Driver(cell, 1, torch.device("cpu"), str(tmp_path)).setup()
    assert not built

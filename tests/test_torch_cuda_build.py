"""`ops/cuda_build.py`, the one path by which the kernel wrappers load and
launch their libraries, on the CPU.

- The table's argument types match each entry's C signature in `csrc/`.
- `route` refuses autograd, mixed devices and devices other than cuda and
  cpu for every wrapper, and sends CPU tensors to the plain versions.
- `Kernel.launch` passes the stream last, raises with the library's error
  string and the caller's shape text on a non-zero return, and counts only
  launches that returned 0 (the library stubbed: a CUDA build runs only on
  the card).
- `build_all` builds every library of the table by default, or those named.
"""

import ctypes
import re
import threading
from contextlib import nullcontext
from pathlib import Path

import pytest
import torch

from clip_retrieval_tpu_torch.ops import adc_scan, block_fused, cuda_build, flash, int8scan

CSRC = Path(cuda_build.CSRC)
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_signatures(source: str) -> dict[str, tuple]:
    """{entry: ctypes argument types} of the `int crt_*(...)` entries in `source`."""
    sigs = {}
    for name, params in re.findall(r"^int (crt_\w+)\(([^)]*)\)", source, re.M):
        types = []
        for param in params.split(","):
            decl = " ".join(param.split()[:-1]) if "*" not in param else "*"
            types.append(ctypes.c_void_p if decl == "*" else C_TYPES[decl.replace("const ", "")])
        sigs[name] = tuple(types)
    return sigs


@pytest.mark.parametrize("library", sorted(cuda_build.LIBRARIES))
def test_table_matches_the_c_signatures(library):
    sources, entries = cuda_build.LIBRARIES[library]
    found = {}
    for src in sources:
        text = (CSRC / src).read_text()
        assert "const char* crt_cuda_error_string(int err)" in text, src
        found.update(_c_signatures(text))
    assert found == entries


def _wrapper_calls(device="cpu", requires_grad=False):
    """One call of every wrapper on tiny valid inputs: (name, thunk)."""
    f32 = dict(dtype=torch.float32, device=device)
    q = torch.randn(1, 4, 8, requires_grad=requires_grad, **f32)
    acc = torch.randn(3, 8, requires_grad=requires_grad, **f32)
    ln = torch.ones(8, **f32)
    lut = torch.randn(1, 2, 256, requires_grad=requires_grad, **f32)
    i32 = dict(dtype=torch.int32, device=device)
    return [
        ("flash_attention_packed", lambda: flash.flash_attention_packed(q, q, q, 2)),
        ("flash_attention", lambda: flash.flash_attention(*(q.reshape(1, 1, 4, 8),) * 3)),
        ("dense_epilogue", lambda: block_fused.dense_epilogue(acc, ln, dtype=torch.float32)),
        ("layernorm", lambda: block_fused.layernorm(acc, ln, ln * 0, 1e-5)),
        ("rope_epilogue", lambda: block_fused.rope_epilogue(q, None, torch.ones(2, 3, 2, **f32), prefix=1,
                                                            dtype=torch.float32)),
        ("glu_layernorm", lambda: block_fused.glu_layernorm(acc, None, ln[:4], ln[:4] * 0, 1e-5, dtype=torch.float32)),
        ("dense_gemm", lambda: block_fused.dense_gemm(acc, acc.t(), ln[:3], act="gelu_tanh", dtype=torch.float32)),
        ("int8_gather_scan", lambda: int8scan.int8_gather_scan(
            torch.ones(1, 4, dtype=torch.int8, device=device), lut[0, 0, :1], torch.ones(1, 2, 4, dtype=torch.int8,
            device=device), torch.ones(1, 2, **f32), torch.zeros(1, 2, **i32), torch.zeros(1, **i32))),
        ("adc_scan", lambda: adc_scan.adc_scan(
            torch.zeros(adc_scan.CHUNK, 2, dtype=torch.uint8, device=device), lut, torch.zeros(1, **i32),
            torch.ones(1, **i32), torch.zeros(1, **i32), torch.zeros(1, **f32))),
    ]


@pytest.mark.parametrize("index", range(9))
def test_every_wrapper_routes_through_cuda_build(index):
    name, call = _wrapper_calls()[index]
    assert call().device.type == "cpu"  # the plain version
    name, call = _wrapper_calls(requires_grad=True)[index]
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call()
    with torch.no_grad():
        call()
    name, call = _wrapper_calls(device="meta")[index]
    with pytest.raises(ValueError, match="cuda or cpu"):
        call()


def test_route_names_mixed_devices_and_skips_absent_tensors():
    x = torch.zeros(2)
    assert cuda_build.route("f", x, None, x) == "cpu"
    with pytest.raises(ValueError, match="f: inputs on different devices"):
        cuda_build.route("f", x, torch.zeros(2, device="meta"))


class _Lib:
    """Stands in for a loaded library: records each entry call, returns `rc`."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, []

    def crt_flash_packed(self, *args):
        self.calls.append(args)
        return self.rc

    @staticmethod
    def crt_cuda_error_string(rc: int) -> bytes:
        return b"an illegal memory access was encountered"


def _counted():
    pass


def test_launch_passes_the_stream_raises_with_the_shape_and_counts(monkeypatch):
    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    kernel = cuda_build.Kernel(flash.LIBRARY, "crt_flash_packed")
    _counted.launches = 0
    for rc in (0, 700):
        lib = _Lib(rc)
        monkeypatch.setattr(cuda_build, "load_library", lambda name, lib=lib: lib)
        kernel.load()
        if rc:
            want = r"crt_flash_packed kernel launch failed \(700: an illegal memory access .*\) at B=2"
            with pytest.raises(RuntimeError, match=want):
                kernel.launch(_counted, torch.device("cpu"), lambda: "B=2", 7, 8)
        else:
            kernel.launch(_counted, torch.device("cpu"), lambda: "B=2", 7, 8)
        assert lib.calls == [(7, 8, 1234)]
        assert _counted.launches == 1  # the failed launch is not counted


def test_launch_counts_from_many_threads(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(cuda_build, "load_library", lambda name: _Lib(0))
    kernel = cuda_build.Kernel(flash.LIBRARY, "crt_flash_packed")
    _counted.launches = 0

    def work():
        for _ in range(500):
            kernel.launch(_counted, torch.device("cpu"), str)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _counted.launches == 8 * 500


def test_launch_counts_by_route(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(cuda_build, "load_library", lambda name: _Lib(0))
    kernel = cuda_build.Kernel(flash.LIBRARY, "crt_flash_packed")
    _counted.launches = 0
    _counted.launches_by_route = {"wgmma": 0, "mma_sync": 0}
    for route in ("wgmma", "wgmma", "mma_sync", None):
        kernel.launch(_counted, torch.device("cpu"), str, route=route)
    assert _counted.launches == 4
    assert _counted.launches_by_route == {"wgmma": 2, "mma_sync": 1}


def test_kernel_refuses_an_entry_outside_the_table():
    with pytest.raises(KeyError, match="not an entry"):
        cuda_build.Kernel(flash.LIBRARY, "crt_adc_scan")


def test_build_all_builds_the_table_by_default(monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_build, "load_library", seen.append)
    assert set(cuda_build.build_all()) == set(cuda_build.LIBRARIES) == set(seen)
    seen.clear()
    assert list(cuda_build.build_all((flash.LIBRARY, block_fused.LIBRARY))) == ["flash_packed", "block_fused"]
    assert sorted(seen) == ["block_fused", "flash_packed"]

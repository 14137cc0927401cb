"""Build the package's CUDA sources with nvcc, load them through ctypes and
launch their entries.

`LIBRARIES` is the one table of the kernel libraries: each one's sources
under `clip_retrieval_tpu_torch/csrc/` and the ctypes argument types of each
entry.  Every entry takes the stream last and returns a cudaError_t value
(0 on success), which `crt_cuda_error_string`, in every library, names.

A library is compiled at first use into `build/torch_kernels/<hash>/` at the
root of the checkout, where the hash covers the sources, the headers under
`csrc/`, the nvcc flags and `nvcc --version`.  The kernels build only from a
checkout (a directory holding `pyproject.toml` above the package); an
installed copy of the package refuses to build rather than write beside
site-packages.  A source with a plain C interface builds in seconds; nothing
includes PyTorch's headers.
Each library has its own lock, so different libraries build in parallel when
called from several threads (`build_all`).  Nothing here runs at import
time: the CPU tests import every module.

The wrappers (`ops/flash.py`, `ops/block_fused.py`, `ops/int8scan.py`,
`ops/adc_scan.py`) hold one `Kernel` per entry.  A call goes through `route`
(no kernel has a backward; every input on one device, cuda or cpu), then,
on CUDA tensors, `Kernel.launch` (the tensors' device and current stream,
the error raised, the launch counted).  This module imports none of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
CHECKOUT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# every pointer and the stream as c_void_p: a default int would cut them to 32 bits
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# library name → (its sources under csrc/, {entry: argument types})
LIBRARIES: dict[str, tuple[tuple[str, ...], dict[str, tuple]]] = {
    "flash_packed": (("flash_packed.cu",), {  # K1 and K2
        "crt_flash_packed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "crt_flash_bhsd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    }),
    "block_fused": (("block_fused.cu",), {
        "crt_dense_epilogue": (_P, _P, _P, _P, _LL, _I, _I, _I, _P),
        "crt_layernorm": (_P, _P, _P, _P, _LL, _I, _F, _I, _P),
        "crt_rope": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
        "crt_glu_layernorm": (_P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _P),
    }),
    "dense_gemm": (("dense_gemm.cu",), {
        "crt_dense_gemm": (_P, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I, _I, _P),
    }),
    "int8_scan": (("int8_scan.cu",), {  # K3
        "crt_int8_gather_scan": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    }),
    "adc_scan": (("adc_scan.cu",), {  # K4
        "crt_adc_scan": (_P, _LL, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    }),
}

_LOCK = threading.Lock()  # guards _NAME_LOCKS
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()  # wrappers run on several server threads at once


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _digest(sources: list[Path], nvcc: str) -> str:
    h = hashlib.sha256()
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:  # the headers the sources may include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True, check=True).stdout)
    return h.hexdigest()[:16]


def _compile(name: str, sources: tuple[str, ...]) -> Path:
    """lib<name>.so from `sources`, compiled unless the hash's directory has it."""
    if not (CHECKOUT / "pyproject.toml").exists():
        raise RuntimeError(f"the CUDA kernels build only from a checkout; no pyproject.toml in {CHECKOUT}")
    nvcc = nvcc_path()
    srcs = [CSRC / s for s in sources]
    out_dir = CHECKOUT / "build" / "torch_kernels" / _digest(srcs, nvcc)
    so_path = out_dir / f"lib{name}.so"
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so_path)  # concurrent builds publish atomically
    return so_path


def declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Give `lib`'s entries the signatures `LIBRARIES[name]` lists (the A/B
    tools load other checkouts' builds of a library through this too)."""
    for entry, argtypes in LIBRARIES[name][1].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = list(argtypes), _I
    lib.crt_cuda_error_string.argtypes, lib.crt_cuda_error_string.restype = [_I], ctypes.c_char_p
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Library `name` of `LIBRARIES`, compiled once and loaded with its
    entries declared.  Raises with nvcc's output when the build fails."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _LIBS:
            _LIBS[name] = declare(ctypes.CDLL(str(_compile(name, LIBRARIES[name][0]))), name)
        return _LIBS[name]


def build_all(names: tuple[str, ...] | None = None) -> dict[str, float]:
    """Build the kernel libraries `names` (every one of `LIBRARIES` by
    default) at once, one nvcc per source started together; returns each
    library's build seconds.  Raises the first failure after all builds have
    ended."""
    names = tuple(LIBRARIES if names is None else names)

    def timed(name: str) -> float:
        t0 = time.perf_counter()
        load_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def route(name: str, *tensors: torch.Tensor | None) -> str:
    """Where wrapper `name`'s call runs: "cuda" (its kernel) or "cpu" (its
    plain version).  Raises RuntimeError when autograd would record the call
    (an input requires grad under grad mode: no kernel has a backward), and
    ValueError for inputs on several devices or on one that is neither."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: an input requires grad; train through {name}_reference "
                           "(attention: impl='xla')")
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on different devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {kind}")
    return kind


class Kernel:
    """Entry `entry` of library `library` (both in `LIBRARIES`), loaded at its
    first launch."""

    def __init__(self, library: str, entry: str):
        if entry not in LIBRARIES[library][1]:
            raise KeyError(f"{entry} is not an entry of {library} in LIBRARIES")
        self.library, self.entry = library, entry
        self._lib = self._fn = None

    def load(self) -> None:
        """Build (or find) and load the library now."""
        lib = load_library(self.library)
        self._lib, self._fn = lib, getattr(lib, self.entry)

    def launch(self, counter, device: torch.device, where, *args, route: str | None = None) -> None:
        """Run the entry on `device`'s current stream with `args`, then add one
        to `counter.launches` (the wrapper function) and, given the device
        route the call took, to `counter.launches_by_route[route]`.  A
        non-zero return raises RuntimeError naming the error and `where()`,
        the call's shape."""
        if self._fn is None:
            self.load()
        with torch.cuda.device(device):
            rc = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            msg = self._lib.crt_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.entry} kernel launch failed ({rc}: {msg}) at {where()}")
        with _COUNT_LOCK:
            counter.launches += 1
            if route is not None:
                counter.launches_by_route[route] += 1

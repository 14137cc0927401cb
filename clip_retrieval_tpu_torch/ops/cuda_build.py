"""Build the package's CUDA sources with nvcc and load them through ctypes.

Each library is compiled at first use from `clip_retrieval_tpu_torch/csrc/`
into `build/torch_kernels/<hash>/` at the root of the checkout, where the
hash covers the sources, the nvcc flags and `nvcc --version`.  The kernels
build only from a checkout (a directory holding `pyproject.toml` above the
package); an installed copy of the package refuses to build rather than
write beside site-packages.  A source with a plain C interface builds in
seconds; nothing includes PyTorch's headers.  Each library has its own lock,
so different libraries build in parallel when called from several threads
(`build_all`).  Nothing here runs at import time: the CPU tests import every
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
CHECKOUT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()  # guards _NAME_LOCKS
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


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
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True, check=True).stdout)
    return h.hexdigest()[:16]


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into lib<name>.so once and
    load it.  Raises with nvcc's output when the build fails."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        if name in _LIBS:
            return _LIBS[name]
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
            os.replace(tmp, so_path)  # concurrent builders publish atomically
        lib = ctypes.CDLL(str(so_path))
        _LIBS[name] = lib
        return lib


def build_all(names: tuple[str, ...] | None = None) -> dict[str, float]:
    """Build the kernel libraries `names` (every one of the package by
    default) at once, one nvcc per source started together; returns each
    library's build seconds.  Raises the first failure after all builds have
    ended."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    from . import adc_scan, block_fused, flash, int8scan

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    build_fns = {"flash_packed": flash.build, "int8_scan": int8scan.build, "adc_scan": adc_scan.build,
                 "block_fused": block_fused.build}
    if names is not None:
        build_fns = {name: build_fns[name] for name in names}
    with ThreadPoolExecutor(len(build_fns)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in build_fns.items()}
        return {name: f.result() for name, f in futures.items()}

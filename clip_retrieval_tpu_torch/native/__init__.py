"""Native (C++) host pieces, compiled with g++ at first use and loaded via ctypes.

Counterpart of `clip_retrieval_tpu/native/__init__.py`, with copies of its two
sources: `image_decode.cpp` (JPEG/PNG/WebP decode + bicubic resize + center
crop) and `adc_scan.cpp` (the host IVF-PQ ADC scanner).  Each library builds
once into `build/native/<hash>/` at the root of the checkout, where the hash
covers the source, the flags and the host's CPU flags (`-march=native` output
is CPU-specific).  Outside a checkout, or without a compiler, a getter
returns None and its caller takes the numpy/PIL route.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_LOCK = threading.Lock()
_LIB: dict[str, Optional[ctypes.CDLL]] = {}
_SRC = Path(__file__).resolve().parent
CHECKOUT = Path(__file__).resolve().parents[2]


def _cpu_tag() -> bytes:
    """Host ISA discriminator for the build hash."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return hashlib.sha256(line).digest()[:8]
    except OSError:
        pass
    import platform

    return platform.machine().encode()


def _build(src_path: Path, extra_flags: list[str]) -> Optional[ctypes.CDLL]:
    if not (CHECKOUT / "pyproject.toml").exists():
        print(f"native build skipped: no checkout (pyproject.toml) at {CHECKOUT}")
        return None
    cmd_head = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-fopenmp", str(src_path),
                *extra_flags]
    tag = hashlib.sha256(src_path.read_bytes() + "\0".join(cmd_head).encode() + _cpu_tag()).hexdigest()[:16]
    out_dir = CHECKOUT / "build" / "native" / tag
    so_path = out_dir / f"{src_path.stem}.so"
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # per-process tmp name: concurrent builds publish atomically
        tmp = out_dir / f"{src_path.stem}.so.{os.getpid()}.tmp"
        try:
            subprocess.run([*cmd_head, "-o", str(tmp)], check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
            print(f"native build failed ({e}); using the numpy/PIL route")
            return None
        finally:
            tmp.unlink(missing_ok=True)
    try:
        return ctypes.CDLL(str(so_path))
    except OSError as e:
        print(f"native load failed ({e}); using the numpy/PIL route")
        return None


def get_decode_lib() -> Optional[ctypes.CDLL]:
    """Compiled image decode/resize library, or None (PIL route).
    CRT_DISABLE_NATIVE_DECODE=1 forces None."""
    with _LOCK:
        if "decode" not in _LIB:
            if os.environ.get("CRT_DISABLE_NATIVE_DECODE") == "1":
                _LIB["decode"] = None
                return None
            lib = _build(_SRC / "image_decode.cpp", ["-ljpeg", "-lpng", "-lwebp"])
            if lib is not None:
                import numpy as np
                from numpy.ctypeslib import ndpointer

                lib.crt_decode_resize_crop.restype = ctypes.c_int32
                lib.crt_decode_resize_crop.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ndpointer(np.uint8, flags="C"),
                ]
                lib.crt_decode_batch.restype = None
                lib.crt_decode_batch.argtypes = [
                    ndpointer(np.uint8, flags="C"), ndpointer(np.int64, flags="C"), ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ndpointer(np.uint8, flags="C"), ndpointer(np.int32, flags="C"),
                ]
            _LIB["decode"] = lib
        return _LIB["decode"]


def get_adc_lib() -> Optional[ctypes.CDLL]:
    """Compiled host ADC scan library, or None (numpy route)."""
    with _LOCK:
        if "adc" not in _LIB:
            lib = _build(_SRC / "adc_scan.cpp", [])
            if lib is not None:
                import numpy as np
                from numpy.ctypeslib import ndpointer

                u8, i64, i32, f32 = (ndpointer(t, flags="C") for t in (np.uint8, np.int64, np.int32, np.float32))
                lib.adc_scan_block.restype = None
                lib.adc_scan_block.argtypes = [u8, ctypes.c_int64, ctypes.c_int32, f32, ctypes.c_float, f32]
                lib.adc_scan_lists.restype = ctypes.c_int64
                lib.adc_scan_lists.argtypes = [u8, i64, i64, i32, ctypes.c_int32, f32, ctypes.c_int32, f32, f32, i64]
                lib.adc_search_batch.restype = None
                lib.adc_search_batch.argtypes = [
                    u8, i64, i64, i32, ctypes.c_int32, f32, ctypes.c_int32, f32, ctypes.c_int32, ctypes.c_int32,
                    f32, i64,
                ]
            _LIB["adc"] = lib
        return _LIB["adc"]

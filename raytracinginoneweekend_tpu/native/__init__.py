"""Native (C++) runtime tier, loaded via ctypes.

The reference is 100% native (C++20/CUDA); this build keeps its compute
path in XLA/Pallas (that IS the native tier for device code) and implements
the host-side runtime pieces -- gamma/quantize and image encoding (SURVEY
#22/#23) -- in C++ (native/imagecodec.cpp), with the pure-Python writers in
io/image.py as the always-available fallback.

``lib()`` returns the loaded ctypes library, building it with g++ on first
use (cached as libimagecodec.so next to the sources); returns None when no
toolchain is available, and callers fall back to Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "imagecodec.cpp")
_SO = os.path.join(_DIR, "libimagecodec.so")

_lock = threading.Lock()
_lib = None
_tried = False


def build(force: bool = False) -> str | None:
    """Compile the native library; returns the .so path or None."""
    if not force and os.path.exists(_SO) and (
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    # Per-process tmp name: concurrent first-use builders (e.g. the two
    # jax.distributed test workers) must not interleave g++ output into one
    # shared tmp file; each writes its own, and os.replace stays atomic.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o",
           tmp, "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build()
        if so is None:
            return None
        try:
            l = ctypes.CDLL(so)
        except OSError:
            return None
        l.rtw_gamma_quantize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        l.rtw_gamma_quantize.restype = None
        l.rtw_write_ppm.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int]
        l.rtw_write_ppm.restype = ctypes.c_int
        l.rtw_write_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int]
        l.rtw_write_png.restype = ctypes.c_int
        _lib = l
        return _lib


def gamma_quantize(rgb_f32, clamp: bool = True):
    """Gamma 1/2.2 + u8 quantize on the host via C++; None if no native lib.

    rgb_f32: contiguous float32 numpy array (any shape); returns uint8 of
    the same shape.
    """
    import numpy as np

    l = lib()
    if l is None:
        return None
    arr = np.ascontiguousarray(rgb_f32, np.float32)
    out = np.empty(arr.shape, np.uint8)
    l.rtw_gamma_quantize(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if clamp else 0)
    return out


def write_ppm(path: str, u8) -> bool:
    import numpy as np

    l = lib()
    if l is None:
        return False
    arr = np.ascontiguousarray(u8, np.uint8)
    h, w, _ = arr.shape
    return l.rtw_write_ppm(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h) == 0


def write_png(path: str, u8) -> bool:
    import numpy as np

    l = lib()
    if l is None:
        return False
    arr = np.ascontiguousarray(u8, np.uint8)
    h, w, _ = arr.shape
    return l.rtw_write_png(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h) == 0

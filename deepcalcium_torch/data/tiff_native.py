"""ctypes binding to the repository's native multithreaded TIFF decoder.

Port of ``deepcalcium_tpu.data.tiff_native``. The source
``native/tiff_loader.cpp`` is compiled with ``g++ -O3 -shared -fPIC``
(linked with libtiff) into ``build/deepcalcium_torch/`` at the root of the
checkout at first use, named by a hash of the source and flags; nothing
is written under ``native/``. When the toolchain or libtiff is missing,
:func:`available` is False and callers decode with PIL, as the JAX package
does: decoding is host work, so this fallback hides no device.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "tiff_size", "decode_batch"]

logger = logging.getLogger(__name__)

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "tiff_loader.cpp"
BUILD_DIR = _REPO / "build" / "deepcalcium_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LIBS = ["-ltiff", "-lpthread"]

_lib = None
_lock = threading.Lock()
_build_failed = False


def _build() -> Path:
    """Compile the loader unless a library for this source and these flags
    exists; returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libdctiff_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE), *LIBS]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native TIFF loader unavailable (%s); decoding "
                           "with PIL", e)
            _build_failed = True
            return None
        lib.dc_tiff_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.dc_tiff_size.restype = ctypes.c_int
        lib.dc_decode_tiff_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.dc_decode_tiff_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native loader built and loaded."""
    return _load() is not None


def tiff_size(path: str):
    """(h, w) of a TIFF, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.dc_tiff_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_batch(paths, height: int, width: int, nthreads: int | None = None):
    """Decode TIFF files into an (N, H, W) int16 array with a thread pool.

    # Returns
        (frames, status): status[i] == 1 marks a frame that failed and was
        zero-filled.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native TIFF loader unavailable")
    n = len(paths)
    out = np.zeros((n, height, width), np.int16)
    status = np.zeros((n,), np.uint8)
    nthreads = nthreads or min(16, max(1, (os.cpu_count() or 2) - 1))
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.dc_decode_tiff_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        height, width, nthreads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, status

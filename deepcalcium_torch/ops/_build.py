"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, named by a hash of the sources and
flags, under ``build/deepcalcium_torch/`` at the root of the checkout, at
first use; later calls in any process load the built library. Nothing is
compiled or imported when this module is imported: the machine that runs
the tests has no ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_library", "raise_on"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "deepcalcium_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({home}); the CUDA kernels cannot be built")


def build_library() -> tuple[Path, float]:
    """Compile ``csrc/*.cu`` unless a library for these exact sources and
    flags exists. Returns (path, seconds spent compiling: 0 if cached).
    The compiler's output, ptxas register counts included, is kept beside
    the library as ``<name>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libdc_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    so, _ = build_library()
    lib = ctypes.CDLL(str(so))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.dc_movie_summary.argtypes = [p, ctypes.c_int, ll, ll, p, p, p]
    lib.dc_movie_summary.restype = ctypes.c_int
    lib.dc_movie_fold.argtypes = [p, ctypes.c_int, ll, ll, p, p, p]
    lib.dc_movie_fold.restype = ctypes.c_int
    i = ctypes.c_int
    lib.dc_euler_steps.argtypes = [p, i, i, p, ll, i, p, p]
    lib.dc_euler_steps.restype = ctypes.c_int
    lib.dc_diffuse.argtypes = [p, p, p, i, i, i, p, p, p]
    lib.dc_diffuse.restype = ctypes.c_int
    lib.dc_rel_pos_attention.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                         ctypes.c_float, p]
    lib.dc_rel_pos_attention.restype = ctypes.c_int
    lib.dc_error_string.argtypes = [ctypes.c_int]
    lib.dc_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(err: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({load_library().dc_error_string(err).decode()})")

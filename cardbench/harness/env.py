"""Where a run keeps its caches and scratch files, and the modules it must
not load.

Every build and kernel cache lies at a fixed path inside the checkout,
under ``build/`` (the measured package builds its kernel library into
``build/deepcalcium_torch/`` itself), so that only a checkout's first run
compiles. Checkpoints and other scratch files go under ``$TMPDIR``."""

import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "build" / "cardbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepcalcium_tpu")


def prepare():
    """Ready a run's process (before PyTorch is imported): the compilers'
    caches at fixed directories in the checkout, the measured package's
    own directory under ``$TMPDIR``, and one CPU thread for PyTorch's
    operators. The card's host shares its cores, and with eight threads
    the wrappers' CPU work (the net built each evaluate call) spread four
    times as wide from call to call as with one, at about the same median
    (PERF.md)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["DEEPCALCIUM_TPU_DIR"] = str(scratch("dc_home"))
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def scratch(name: str) -> Path:
    """A fixed directory under ``$TMPDIR`` for a run's files."""
    path = Path(tempfile.gettempdir()) / "cardbench" / name
    path.mkdir(parents=True, exist_ok=True)
    return path


def forbidden_loaded():
    """Top-level names of the loaded modules that the benchmark must not
    load, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))

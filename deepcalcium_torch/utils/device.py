"""Device selection: the port runs its main path on a CUDA card and never
falls back to the CPU when none is found."""

import torch

__all__ = ["require_cuda"]


def require_cuda() -> torch.device:
    """Return the current CUDA device, or raise if this process sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            f"False; torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda})")
    return torch.device("cuda", torch.cuda.current_device())

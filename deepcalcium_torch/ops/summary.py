"""Mean and max summary images of a (T, H, W) movie over its time axis.

Port of ``deepcalcium_tpu.ops.summary``:

- :func:`movie_summary` -- the plain PyTorch version. It runs on the CPU
  and is the oracle of the kernel on the card.
- :func:`movie_summary_cuda` -- kernel K1 (``csrc/summary.cu``), written by
  hand for Hopper in place of the Pallas kernel ``movie_summary_pallas``.
- :func:`movie_summary_fast` -- dispatch by the tensor's device: K1 for a
  CUDA tensor, the plain version for a CPU tensor.

Both versions return the correctly rounded float32 time-sum divided by T:
integer movies are summed exactly, float32 movies in float64. So the two
agree bitwise, and with the JAX package's float32 sum wherever that sum is
exact (integer sums below 2**24).
"""

import ctypes

import torch

__all__ = ["movie_summary", "movie_summary_cuda", "movie_summary_fast"]

# Codes of the input dtypes K1 is instantiated for (csrc/summary.cu).
_K1_DTYPES = {torch.int16: 0, torch.uint16: 1, torch.float32: 2}


def _check_movie(movie):
    if movie.dim() != 3:
        raise ValueError(f"movie must be (T, H, W), got shape "
                         f"{tuple(movie.shape)}")
    if movie.numel() == 0:
        raise ValueError(f"movie is empty: shape {tuple(movie.shape)}")


def _divide(total, t):
    # A full-size divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not always the IEEE quotient.
    return total / torch.full_like(total, float(t))


def movie_summary(movie: torch.Tensor, chunk: int = 64):
    """Plain mean and max projections, ``chunk`` frames at a time so that no
    (T, H, W) copy is made.

    # Returns
        (mean, mx): (H, W) float32 mean and (H, W) max in the input dtype.
    """
    _check_movie(movie)
    t = movie.shape[0]
    acc = torch.int64 if not movie.dtype.is_floating_point else torch.float64
    total = torch.zeros(movie.shape[1:], dtype=acc, device=movie.device)
    mx = None
    for i in range(0, t, chunk):
        x = movie[i:i + chunk]
        if x.dtype == torch.uint16:
            # PyTorch implements few ops for uint16; int32 holds it exactly.
            x = x.to(torch.int32)
        total += x.sum(dim=0, dtype=acc)
        cmax = x.amax(dim=0)
        mx = cmax if mx is None else torch.maximum(mx, cmax)
    return _divide(total.to(torch.float32), t), mx.to(movie.dtype)


def movie_summary_cuda(movie: torch.Tensor):
    """Kernel K1: mean and max in one pass over a contiguous CUDA movie.

    # Returns
        (mean, mx): two (H, W) float32 tensors on the movie's device.
    """
    if movie.device.type != "cuda":
        raise ValueError(f"movie_summary_cuda needs a CUDA tensor, got one "
                         f"on {movie.device}")
    if movie.dtype not in _K1_DTYPES:
        raise TypeError(f"movie_summary_cuda takes {list(_K1_DTYPES)}, got "
                        f"{movie.dtype}")
    _check_movie(movie)
    if not movie.is_contiguous():
        raise ValueError("movie_summary_cuda needs a contiguous movie")
    from deepcalcium_torch.ops._build import load_library

    lib = load_library()
    t, h, w = movie.shape
    mean = torch.empty((h, w), dtype=torch.float32, device=movie.device)
    mx = torch.empty_like(mean)
    with torch.cuda.device(movie.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dc_movie_summary(
            ctypes.c_void_p(movie.data_ptr()), _K1_DTYPES[movie.dtype], t,
            h * w, ctypes.c_void_p(mean.data_ptr()),
            ctypes.c_void_p(mx.data_ptr()), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                           f"({lib.dc_error_string(err).decode()})")
    movie_summary_cuda.launches += 1
    return mean, mx


movie_summary_cuda.launches = 0


def movie_summary_fast(movie: torch.Tensor):
    """K1 for a CUDA tensor, the plain version for a CPU tensor.

    # Returns
        (mean, mx): (H, W) float32 mean and max (the max is float32 on both
        paths, as the Pallas path returns it).
    """
    if movie.device.type == "cuda":
        return movie_summary_cuda(movie)
    if movie.device.type == "cpu":
        mean, mx = movie_summary(movie)
        return mean, mx.to(torch.float32)
    raise ValueError(f"no summary path for a tensor on {movie.device}")

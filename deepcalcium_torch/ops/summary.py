"""Mean and max summary images of a (T, H, W) movie over its time axis.

Port of ``deepcalcium_tpu.ops.summary``:

- :func:`movie_summary` -- the plain PyTorch version. It runs on the CPU
  and is the oracle of the kernel on the card.
- :func:`movie_summary_cuda` -- kernel K1 (``csrc/summary.cu``), written by
  hand for Hopper in place of the Pallas kernel ``movie_summary_pallas``.
- :func:`movie_summary_fast` -- dispatch by the tensor's device: K1 for a
  CUDA tensor, the plain version for a CPU tensor.
- :func:`movie_fold` / :func:`movie_fold_cuda` / :func:`movie_fold_fast` --
  the streaming fold: frames ``[0, n_valid)`` of one chunk added into
  running totals and a running max, in place. The CUDA version is K1's
  second entry (``dc_movie_fold``), in place of the XLA updates
  ``_streaming_device_update(_mean)`` of the JAX package.
- :class:`StreamingSummary` -- folds chunks of a movie that lives on the
  host (an array, an HDF5 dataset, decoded TIFFs) into mean and max, on the
  device the caller names.
- :func:`movie_summary_sharded` -- the time axis split over the ranks of a
  mesh: each rank folds its frames (K1's fold on a card), the totals and the
  max are all-reduced.

Both versions return the correctly rounded float32 time-sum divided by T:
integer movies are summed exactly, float32 movies in float64. So the two
agree bitwise, and with the JAX package's float32 sum wherever that sum is
exact (integer sums below 2**24). A fold finalised by
:func:`finalise_fold` is bitwise equal to one K1 call on the whole movie
for integer movies, over any chunking; for float32 movies it is within
1 ulp, as the float64 partial sums are grouped differently.
"""

import ctypes

import numpy as np
import torch
import torch.distributed as dist

from deepcalcium_torch.parallel.mesh import check_mesh

__all__ = ["movie_summary", "movie_summary_cuda", "movie_summary_fast",
           "movie_fold", "movie_fold_cuda", "movie_fold_fast",
           "fold_accumulators", "finalise_fold", "StreamingSummary",
           "movie_summary_sharded"]

# Codes of the input dtypes K1 is instantiated for (csrc/summary.cu).
_K1_DTYPES = {torch.int16: 0, torch.uint16: 1, torch.float32: 2}
_NP_TO_TORCH = {np.dtype(np.int16): torch.int16,
                np.dtype(np.uint16): torch.uint16,
                np.dtype(np.float32): torch.float32}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


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


# --- The streaming fold ------------------------------------------------------

def _acc_dtype(dtype):
    """The exact running-total dtype of a movie dtype."""
    return torch.float64 if dtype.is_floating_point else torch.int64


def fold_accumulators(frame_shape, dtype, device, track_max=True):
    """Zeroed running totals and, with ``track_max``, a running max of -inf
    (float32) for movies of ``dtype``, on ``device``."""
    total = torch.zeros(tuple(frame_shape), dtype=_acc_dtype(dtype),
                        device=device)
    mx = (torch.full(tuple(frame_shape), -float("inf"), dtype=torch.float32,
                     device=device) if track_max else None)
    return total, mx


def _check_fold(chunk, n_valid, total, mx):
    if chunk.dim() != 3:
        raise ValueError(f"chunk must be (C, H, W), got shape "
                         f"{tuple(chunk.shape)}")
    if not 1 <= n_valid <= chunk.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [1, {chunk.shape[0]}]")
    if total.dtype != _acc_dtype(chunk.dtype):
        raise TypeError(f"a {chunk.dtype} chunk folds into "
                        f"{_acc_dtype(chunk.dtype)} totals, got {total.dtype}")
    if tuple(total.shape) != tuple(chunk.shape[1:]):
        raise ValueError(f"totals {tuple(total.shape)} do not match frames "
                         f"{tuple(chunk.shape[1:])}")
    if mx is not None and (mx.dtype != torch.float32
                           or mx.shape != total.shape):
        raise TypeError(f"the running max must be float32 of shape "
                        f"{tuple(total.shape)}, got {mx.dtype} "
                        f"{tuple(mx.shape)}")


def movie_fold(chunk: torch.Tensor, n_valid: int, total: torch.Tensor,
               mx: torch.Tensor | None = None):
    """Plain fold: add frames ``[0, n_valid)`` of ``chunk`` into ``total``
    (int64, or float64 for float32 chunks) and raise ``mx`` (float32) to
    their max, in place, on any device. ``mx=None`` skips the max."""
    _check_fold(chunk, n_valid, total, mx)
    x = chunk[:n_valid]
    if x.dtype == torch.uint16:
        x = x.to(torch.int32)  # few ops exist for uint16
    total += x.sum(dim=0, dtype=total.dtype)
    if mx is not None:
        torch.maximum(mx, x.amax(dim=0).to(torch.float32), out=mx)


def movie_fold_cuda(chunk: torch.Tensor, n_valid: int, total: torch.Tensor,
                    mx: torch.Tensor | None = None):
    """K1's fold entry: the contract of :func:`movie_fold` on a contiguous
    CUDA chunk with accumulators on the same card. Frames from ``n_valid``
    on are never read."""
    tensors = [chunk, total] + ([mx] if mx is not None else [])
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("movie_fold_cuda needs CUDA tensors, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("chunk and accumulators lie on different cards")
    if chunk.dtype not in _K1_DTYPES:
        raise TypeError(f"movie_fold_cuda takes {list(_K1_DTYPES)}, got "
                        f"{chunk.dtype}")
    _check_fold(chunk, n_valid, total, mx)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("movie_fold_cuda needs contiguous tensors")
    from deepcalcium_torch.ops._build import load_library

    lib = load_library()
    h, w = chunk.shape[1:]
    with torch.cuda.device(chunk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dc_movie_fold(
            ctypes.c_void_p(chunk.data_ptr()), _K1_DTYPES[chunk.dtype],
            int(n_valid), h * w, ctypes.c_void_p(total.data_ptr()),
            ctypes.c_void_p(mx.data_ptr() if mx is not None else None),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"K1 fold launch failed: CUDA error {err} "
                           f"({lib.dc_error_string(err).decode()})")
    movie_fold_cuda.launches += 1


movie_fold_cuda.launches = 0


def movie_fold_fast(chunk, n_valid, total, mx=None):
    """K1's fold for a CUDA chunk, the plain fold for a CPU chunk."""
    if chunk.device.type == "cuda":
        return movie_fold_cuda(chunk, n_valid, total, mx)
    if chunk.device.type == "cpu":
        return movie_fold(chunk, n_valid, total, mx)
    raise ValueError(f"no fold for a tensor on {chunk.device}")


def finalise_fold(total: torch.Tensor, count: int) -> torch.Tensor:
    """The float32 mean of ``count`` folded frames, as K1 forms it: the
    total rounded to float32 once, then an IEEE division."""
    return _divide(total.to(torch.float32), count)


class StreamingSummary:
    """Fold host-resident frame chunks into mean and max accumulators.

    Port of ``deepcalcium_tpu.ops.summary.StreamingSummary``. The backend
    follows ``device``: on "cuda" each chunk is staged through one pinned
    host buffer, copied to the card without blocking, and folded by K1;
    on "cpu" the plain fold runs in place. There is no automatic choice
    and no fallback: "cuda" without a card raises.

    Sums are exact (int64 for 16-bit movies, float64 for float32), where
    the JAX package accumulates in float32. A chunk longer than the first
    one seen is split into slabs of that length, so the staging buffers
    keep their size; a shorter chunk folds with ``n_valid`` and is never
    padded.

    # Arguments
        frame_shape: (H, W).
        dtype: int16, uint16 or float32 (numpy or torch).
        device: where the accumulators live and the fold runs.
        track_max: fold the max too; ``result()`` returns None for it
            otherwise.
    """

    def __init__(self, frame_shape, dtype=np.int16, device="cuda",
                 track_max=True):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from deepcalcium_torch.utils.device import require_cuda

            current = require_cuda()
            if self.device.index is None:
                self.device = current
        dtype = (dtype if isinstance(dtype, torch.dtype)
                 else _NP_TO_TORCH.get(np.dtype(dtype)))
        if dtype not in _K1_DTYPES:
            raise TypeError(f"StreamingSummary folds {list(_K1_DTYPES)}, got "
                            f"{dtype}")
        self.dtype = dtype
        self.frame_shape = tuple(frame_shape)
        self.track_max = track_max
        self._total, self._max = fold_accumulators(
            self.frame_shape, dtype, self.device, track_max)
        self._count = 0
        self._chunk_len = None
        self._pinned = None   # host staging buffer (cuda)
        self._staged = None   # its device copy
        self._copied = None   # event recorded after the last host->device copy

    def update(self, chunk) -> None:
        """chunk: (C, H, W) frames, a numpy array or a tensor (a tensor on
        the accumulators' card folds where it lies)."""
        if tuple(chunk.shape[1:]) != self.frame_shape:
            raise ValueError(f"chunk frames {tuple(chunk.shape[1:])} do not "
                             f"match {self.frame_shape}")
        n = int(chunk.shape[0])
        if n == 0:
            return
        if self._chunk_len is None:
            self._chunk_len = n
        if n > self._chunk_len:
            for i in range(0, n, self._chunk_len):
                self.update(chunk[i:i + self._chunk_len])
            return
        x = (chunk if isinstance(chunk, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(chunk)))
        if x.dtype != self.dtype:
            raise TypeError(f"chunk is {x.dtype}, the summary folds "
                            f"{self.dtype}")
        if x.device == self.device:
            movie_fold_fast(x.contiguous(), n, self._total, self._max)
        elif x.device.type == "cpu":
            movie_fold_cuda(self._stage(x, n), n, self._total, self._max)
        else:
            raise ValueError(f"chunk on {x.device}, accumulators on "
                             f"{self.device}")
        self._count += n

    def _stage(self, x, n):
        """Copy ``n`` host frames to the card through the pinned buffer;
        returns the device staging buffer, valid up to frame ``n``."""
        if self._pinned is None:
            shape = (self._chunk_len,) + self.frame_shape
            self._pinned = torch.empty(shape, dtype=self.dtype,
                                       pin_memory=True)
            self._staged = torch.empty(shape, dtype=self.dtype,
                                       device=self.device)
            self._copied = torch.cuda.Event()
        # The previous copy out of the pinned buffer may still be in flight:
        # refilling it before that copy ends would corrupt its frames.
        self._copied.synchronize()
        self._pinned[:n].copy_(x)
        with torch.cuda.device(self.device):
            self._staged[:n].copy_(self._pinned[:n], non_blocking=True)
            self._copied.record()
        return self._staged

    def result(self):
        """(mean float32, max in the input dtype or None) as host numpy
        arrays."""
        if self._count == 0:
            raise ValueError("no frames accumulated")
        mean = finalise_fold(self._total, self._count).cpu().numpy()
        if not self.track_max:
            return mean, None
        # Exact: the running max holds values of the input dtype.
        return mean, self._max.cpu().numpy().astype(
            _TORCH_TO_NP[self.dtype])



def movie_summary_sharded(movie, mesh, chunk: int = 256):
    """Mean and max with the time axis split over the ranks of ``mesh``.

    Port of ``deepcalcium_tpu.ops.summary.movie_summary_sharded``. Every
    rank is handed the same (T, H, W) movie (a tensor, a numpy array or an
    open HDF5 dataset) and reads only its contiguous range of frames, which
    it folds ``chunk`` frames at a time through :class:`StreamingSummary` on
    ``mesh.device`` (K1's fold on a card, the plain fold on the CPU). The
    totals are then summed and the max taken over the ranks, and the mean
    is formed once from the global total.

    The totals are exact, so any split of T gives K1's bits for int16 and
    uint16 movies, and the JAX version's separate tail (for a T the mesh
    does not divide) has no counterpart. A rank whose range is empty
    (T < ``mesh.size``) folds nothing and still takes part in both
    collectives. Float32 movies sum in float64, whose grouping depends on
    the split: the mean is within 1 ulp of one K1 call's.

    # Returns
        (mean, mx): (H, W) float32 tensors on ``mesh.device``, the same on
        every rank.
    """
    if check_mesh(mesh) is None:
        raise TypeError("movie_summary_sharded needs a Mesh")
    if len(movie.shape) != 3 or 0 in tuple(movie.shape):
        raise ValueError(f"movie must be a non-empty (T, H, W), got shape "
                         f"{tuple(movie.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    t, h, w = movie.shape
    lo, hi = t * mesh.rank // mesh.size, t * (mesh.rank + 1) // mesh.size
    ss = StreamingSummary((h, w), dtype=movie.dtype, device=mesh.device)
    for i in range(lo, hi, chunk):
        ss.update(movie[i:min(i + chunk, hi)])
    total, mx = ss._total, ss._max
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.group)
    return finalise_fold(total, t), mx

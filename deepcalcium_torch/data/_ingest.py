"""Shared TIFF -> HDF5 series ingestion core.

Port of ``deepcalcium_tpu.data._ingest``: frames decode in chunks through
the native thread-pool loader (PIL for frames it flags, and when it is
unavailable), corrupted frames zero-fill with a warning, raw frames go to
``series/raw``, and mean and max fold through ``StreamingSummary`` on the
device ``write_series`` is given (K1's fold on the card). ``series/mean`` is
stored float16 per the contract.

One deliberate difference: a floating-point frame from PIL is clamped to
the int16 range, with NaN as 0, before it is stored; the JAX package casts
it, so values past the range wrap.
"""

import logging

import numpy as np

from deepcalcium_torch.ops.summary import StreamingSummary

__all__ = ["read_tiff", "to_int16", "decode_chunk", "write_series"]

logger = logging.getLogger(__name__)


def read_tiff(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def to_int16(frame: np.ndarray) -> np.ndarray:
    """A decoded frame as int16: floating-point values are clamped to the
    int16 range (NaN -> 0) and truncated; integer values cast as numpy
    casts them."""
    frame = np.asarray(frame)
    if frame.dtype.kind == "f":
        frame = np.clip(np.nan_to_num(frame, nan=0.0), -32768, 32767)
    return frame.astype(np.int16)


def decode_chunk(paths, i_shape) -> np.ndarray:
    """Decode TIFF paths -> (N, H, W) int16; corrupted frames zero-fill."""
    from deepcalcium_torch.data import tiff_native

    if tiff_native.available():
        frames, status = tiff_native.decode_batch(list(paths), *i_shape)
        for i, (p, bad) in enumerate(zip(paths, status)):
            if bad:
                # The native loader flags layouts it does not decode exactly
                # as well as corrupt files: retry on PIL before zero-filling.
                try:
                    frames[i] = to_int16(read_tiff(p))  # raises on shape mismatch
                    logger.info("Native decode failed on %s; PIL recovered "
                                "it.", p)
                except (OSError, ValueError) as e:
                    logger.warning("Error on file %s: %s; zero-filled.", p, e)
        return frames
    out = np.zeros((len(paths),) + tuple(i_shape), np.int16)
    for i, p in enumerate(paths):
        try:
            out[i] = to_int16(read_tiff(p))
        except (OSError, ValueError) as e:
            # A frame of the wrong resolution zero-fills too, as on the
            # native loader.
            logger.warning("Error on file %s: %s; zero-filling.", p, e)
    return out


def write_series(dsf, s_paths, i_shape, chunk: int = 64, device="cuda") -> None:
    """Populate ``series/{raw,mean,max}`` of an open HDF5 file from TIFF
    paths, folding the summaries on ``device``. Logs the frames/s of the
    decode, HDF5-write and fold phases."""
    from deepcalcium_torch.utils.profiling import ThroughputMeter

    t = len(s_paths)
    raw = dsf.create_dataset("series/raw", (t,) + tuple(i_shape), dtype="int16")
    summ = StreamingSummary(tuple(i_shape), dtype=np.int16, device=device)
    meter = ThroughputMeter()
    for base in range(0, t, chunk):
        n = len(s_paths[base:base + chunk])
        with meter.track("decode", n):
            frames = decode_chunk(s_paths[base:base + chunk], i_shape)
        with meter.track("hdf5_write", n):
            raw[base:base + frames.shape[0]] = frames
        with meter.track("reduce", n):
            summ.update(frames)
    mean, mx = summ.result()
    dsf.create_dataset("series/mean", data=mean.astype(np.float16),
                       dtype="float16")
    dsf.create_dataset("series/max", data=mx, dtype="int16")
    logger.info("ingest throughput (frames/s): %s",
                {k: round(v, 1) for k, v in meter.rates().items()})

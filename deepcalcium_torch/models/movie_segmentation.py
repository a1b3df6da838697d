"""Full-movie streaming segmentation: per-frame UNet2DS over raw movies.

Port of ``deepcalcium_tpu.models.movie_segmentation.segment_movie``. Each
frame is z-normalised on the device (population std plus 1e-6),
reflect-padded on its high sides to the next multiple of 16, and pushed
through the fully-convolutional UNet2DS in slabs of ``slab`` frames; the
probabilities are cropped, thresholded strictly and returned as uint8.

The movie stays on the host (an array, or an open HDF5 dataset sliced one
slab at a time). A background thread fills pinned staging buffers and
copies them to the card on a side stream while the previous slab computes;
the uint8 masks come back through pinned buffers one slab behind. A staging
slot is refilled only after the event recorded behind its last copy has
completed. The weights go to the card once a call.

Where the JAX package pads the last slab with zero frames to its compiled
shape, the short slab runs as it is here: eval-mode BN makes frames
independent. Its cache of compiled slabs has no counterpart (PyTorch runs
eagerly).

With a ``mesh`` (``parallel.mesh.Mesh``) every rank is handed the same movie
and stages, copies and runs only its frames of each slab; the uint8 masks
are all-gathered, so every rank returns the whole stack. The consumer
thread alone calls the collectives, one a slab, in the same order on every
rank.
"""

import queue

import numpy as np
import torch

from deepcalcium_torch.models.netweights import inference_route
from deepcalcium_torch.models.unet2d import UNet2DS
from deepcalcium_torch.parallel.mesh import all_gather, check_mesh
from deepcalcium_torch.train.evaluate import _reflect_index
from deepcalcium_torch.train.sampler import Prefetcher
from deepcalcium_torch.utils.device import require_cuda

__all__ = ["segment_movie"]

# Slabs in flight: one computing, one whose masks are on their way back, and
# two read ahead.
_SLOTS = 4


def _pad16(hw: int) -> int:
    return -(-hw // 16) * 16


def _resolve_apply(apply_fn, params, state, compute_dtype, device):
    """The forward a call runs: ``apply_fn`` when given; else the net built
    from (params, state) on ``device``, with BN folded into the convs and
    the sigmoid head for a transpose-mode checkpoint (what the JAX
    package's lane-packed inference forward maps to here), and the plain
    forward for an upsampling-mode one."""
    if apply_fn is not None:
        return apply_fn
    return inference_route(UNet2DS, None, params, state, compute_dtype,
                           device, "auto", "up0_tconv" in params)


def _staging_dtype(np_dtype) -> torch.dtype:
    """The dtype a slab is staged in: the movie's own where PyTorch has it
    (16-bit movies cross the bus at 2 bytes a pixel), else float32."""
    try:
        return torch.from_numpy(np.empty(0, np_dtype)).dtype
    except (TypeError, ValueError):  # no such dtype; a foreign byte order
        return torch.float32


class _Slot:
    """Staging buffers of one slab in flight. On the CPU the frames are
    staged where the net reads them and the events are absent."""

    def __init__(self, shape, dtype, device, ranks=1):
        """``shape``: this rank's frames of a slab; the masks that come
        back are those of all ``ranks``."""
        cuda = device.type == "cuda"
        self.host_in = torch.empty(shape, dtype=dtype, pin_memory=cuda)
        self.host_out = torch.empty((shape[0] * ranks,) + tuple(shape[1:]),
                                    dtype=torch.uint8, pin_memory=cuda)
        self.dev_in = (torch.empty(shape, dtype=dtype, device=device)
                       if cuda else self.host_in)
        self.copied = torch.cuda.Event() if cuda else None
        self.done = torch.cuda.Event() if cuda else None


def _segment_slab(forward, x, hp, wp, threshold):
    """(n, H, W) frames on the device -> (n, H, W) uint8 masks."""
    if x.dtype == torch.uint16:
        x = x.to(torch.int32)  # few ops exist for uint16
    x = x.to(torch.float32)
    mean = x.mean(dim=(1, 2), keepdim=True)
    std = x.std(dim=(1, 2), correction=0, keepdim=True) + 1e-6
    x = (x - mean) / std
    h, w = x.shape[1:]
    if (hp, wp) != (h, w):
        rows = _reflect_index(h, hp, x.device)
        cols = _reflect_index(w, wp, x.device)
        x = x[:, rows[:, None], cols[None, :]]
    probs = forward(x)
    return (probs[:, :h, :w] > threshold).to(torch.uint8)


def segment_movie(params, state, movie, slab: int = 64, mesh=None,
                  threshold: float = 0.5, compute_dtype=torch.bfloat16,
                  apply_fn=None, device="cuda"):
    """Segment every frame of a (T, H, W) movie; returns (T, H, W) uint8.

    # Arguments
        params, state: the net's weights in the JAX package's layout (a
            ``.ckpt`` of either package, or a Keras import).
        movie: host array or h5py dataset (sliced lazily, one slab at a
            time); int16, uint16, float32 or any dtype numpy casts to
            float32.
        slab: frames per device batch.
        mesh: each slab's frames are split over the mesh's ranks, so
            ``slab`` must divide by ``mesh.size`` (the JAX package rounds
            it up to a multiple instead); every rank passes the
            same movie and gets every frame's mask. ``device`` must be
            ``mesh.device``'s kind.
        threshold: a pixel is 1 where its probability is strictly above.
        compute_dtype: dtype of the convs; None computes in float32.
        apply_fn: a forward to run in place of the net built from
            ``params``: (B, H', W') float32 tensor on ``device`` ->
            (B, H', W') probabilities, H' and W' multiples of 16.
        device: where the net runs; "cuda" (the default) raises without a
            card. Pass "cpu" to run on the CPU on purpose.
    """
    ranks, rank = 1, 0
    if check_mesh(mesh) is not None:
        ranks, rank = mesh.size, mesh.rank
    if slab < 1:
        raise ValueError(f"slab={slab} must be >= 1")
    if slab % ranks:
        raise ValueError(f"slab={slab} must be divisible by the mesh size "
                         f"{ranks}")
    device = torch.device(device)
    if mesh is not None and device.type != mesh.device.type:
        raise ValueError(f"device {device} is not of the mesh's kind "
                         f"({mesh.device})")
    cuda = device.type == "cuda"
    if cuda:
        current = require_cuda()
        if device.index is None:
            device = current
    t, h, w = movie.shape
    hp, wp = _pad16(h), _pad16(w)
    forward = _resolve_apply(apply_fn, params, state, compute_dtype, device)

    dtype = _staging_dtype(movie.dtype)
    free: queue.Queue = queue.Queue()
    for _ in range(min(_SLOTS, -(-t // slab))):
        free.put(_Slot((slab // ranks, h, w), dtype, device, ranks))
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def staged():
        """Runs on the prefetch thread: read this rank's frames of a slab
        into a free slot and start their copy to the card. The ``n`` frames
        of a slab are split ``per`` to a rank (the short last slab rounded
        up to a multiple of the ranks); a rank whose part reaches past the
        movie's end fills it up with zero frames, which are cut after the
        gather."""
        for t0 in range(0, t, slab):
            slot = free.get()
            if slot is None:  # the consumer gave up
                return
            n = min(slab, t - t0)
            per = -(-n // ranks)
            lo = min(t0 + rank * per, t0 + n)
            mine = min(per, t0 + n - lo)
            staging = slot.host_in[:per].numpy()
            staging[:mine] = movie[lo:lo + mine]
            staging[mine:] = 0
            if cuda:
                with torch.cuda.stream(copy_stream):
                    slot.dev_in[:per].copy_(slot.host_in[:per],
                                            non_blocking=True)
                    slot.copied.record()
            yield t0, n, per, slot

    out = np.empty((t, h, w), np.uint8)

    def drain(item):
        t0, n, _, slot = item
        if cuda:
            slot.done.synchronize()
        out[t0:t0 + n] = slot.host_out[:n].numpy()
        free.put(slot)  # only now may its buffers be refilled

    pending = []  # keep one slab's masks in flight
    prefetch = Prefetcher(staged(), depth=_SLOTS)
    try:
        with torch.inference_mode():
            for t0, n, per, slot in prefetch:
                if cuda:
                    torch.cuda.current_stream(device).wait_event(slot.copied)
                masks = _segment_slab(forward, slot.dev_in[:per], hp, wp,
                                      threshold)
                if mesh is not None:
                    masks = all_gather(masks, mesh)
                slot.host_out[:n].copy_(masks[:n], non_blocking=True)
                if cuda:
                    slot.done.record(torch.cuda.current_stream(device))
                pending.append((t0, n, per, slot))
                if len(pending) >= 2:
                    drain(pending.pop(0))
            for item in pending:
                drain(item)
    finally:
        prefetch.close()
        free.put(None)
    return out

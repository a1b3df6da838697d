"""Neuron-centred training windows, and a background producer that copies
them to the device.

Port of ``deepcalcium_tpu.train.sampler``. :class:`WindowSampler` is the
same numpy code with the same draws from the same seeded generator, so a
seed gives the same batches bit for bit in both packages:

- pick a dataset from a probability vector, optionally re-weighted by
  validation F1 (``1 - mean(F1)``, normalised);
- centre a window on a random neuron pixel of the dataset's training row
  band with +-5 px jitter, zero-padding at the borders;
- apply a random D4 element composed from the reference's augmentation walk.

:class:`Prefetcher` runs the sampler on a thread with a bounded queue, and
:func:`make_put_fn` copies each batch to the device from that thread:
through pinned memory with ``non_blocking=True`` for a CUDA device. For K
steps per dispatch (``trainer.make_multi_step``), :func:`stack_batches`
stacks K batches into one (K, B, ...) slab on that thread.
"""

import queue
import threading

import numpy as np
import torch

from deepcalcium_torch.ops.augment import compose_random_walk
from deepcalcium_torch.parallel.mesh import LocalShard, check_mesh, shard_batch

__all__ = ["WindowSampler", "Prefetcher", "apply_d4_numpy", "make_put_fn",
           "stack_batches"]

_D4_NUMPY = [
    lambda a: a,
    lambda a: a[::-1, :],
    lambda a: a[:, ::-1],
    lambda a: np.rot90(a, 1),
    lambda a: np.rot90(a, 2),
    lambda a: np.rot90(a, 3),
    lambda a: np.rot90(a, 1)[::-1, :],
    lambda a: np.rot90(a, 1)[:, ::-1],
]


def apply_d4_numpy(img: np.ndarray, code: int) -> np.ndarray:
    """Apply D4 element ``code`` to a single (H, W) array."""
    return _D4_NUMPY[code](img)


class WindowSampler:
    """Infinite neuron-centred window batches over several datasets."""

    def __init__(self, S_summ, M_summ, names, y_coords, window_shape,
                 nb_max_augment=0, seed=865):
        if not len(S_summ) == len(M_summ) == len(names) == len(y_coords):
            raise ValueError("S_summ, M_summ, names and y_coords must have "
                             "one entry per dataset")
        self.S = [np.asarray(s, np.float32) for s in S_summ]
        self.M = [np.asarray(m, np.uint8) for m in M_summ]
        self.names = list(names)
        self.y_coords = list(y_coords)
        self.window_shape = tuple(window_shape)
        self.nb_max_augment = nb_max_augment
        self.rng = np.random.default_rng(seed)

        # Neuron locations inside each dataset's sampling row band; datasets
        # with no positive pixel in the band are never sampled.
        self.neuron_locs = []
        for m, (ymin, ymax) in zip(self.M, self.y_coords):
            yy, xx = np.where(m[ymin:ymax, :] == 1)
            self.neuron_locs.append(np.stack([yy + ymin, xx], axis=1))
        self.valid = np.array([len(l) > 0 for l in self.neuron_locs])
        if not self.valid.any():
            raise ValueError("no dataset has positive mask pixels in its band")
        self.ds_probs = self.valid / self.valid.sum()

    def reweight(self, name_to_scores: dict) -> None:
        """Adaptive sampling: weight each dataset by 1 - its mean val F1."""
        w = np.array(
            [1.0 - float(np.mean(name_to_scores.get(n, [0.0]))) for n in self.names]
        )
        w = np.clip(w, 1e-6, None) * self.valid
        self.ds_probs = w / w.sum()

    def sample_batch(self, batch_size: int):
        hw, ww = self.window_shape
        s_batch = np.zeros((batch_size, hw, ww), np.float32)
        m_batch = np.zeros((batch_size, hw, ww), np.uint8)
        for b in range(batch_size):
            ds = int(self.rng.choice(len(self.S), p=self.ds_probs))
            s, m = self.S[ds], self.M[ds]
            hs, ws = s.shape
            ymin, ymax = self.y_coords[ds]
            locs = self.neuron_locs[ds]
            cy, cx = locs[int(self.rng.integers(0, len(locs)))]
            # +-5 jitter, clipped to the band.
            cy = min(max(ymin, cy + int(self.rng.integers(-5, 5))), ymax)
            cx = min(max(0, cx + int(self.rng.integers(-5, 5))), ws)
            y0 = max(ymin, int(cy - hw // 2))
            y1 = min(y0 + hw, ymax)
            x0 = max(0, int(cx - ww // 2))
            x1 = min(x0 + ww, ws)
            s_batch[b, : y1 - y0, : x1 - x0] = s[y0:y1, x0:x1]
            m_batch[b, : y1 - y0, : x1 - x0] = m[y0:y1, x0:x1]
            code = compose_random_walk(self.rng, self.nb_max_augment)
            if code:
                s_batch[b] = apply_d4_numpy(s_batch[b], code)
                m_batch[b] = apply_d4_numpy(m_batch[b], code)
        return s_batch, m_batch.astype(np.float32)

    def batches(self, batch_size: int):
        while True:
            yield self.sample_batch(batch_size)


def make_put_fn(device, mesh=None, kdisp: int = 1):
    """Host-to-device copy of a batch of numpy arrays, for
    :class:`Prefetcher`'s producer thread. For a CUDA device each array goes
    through pinned memory and is copied with ``non_blocking=True`` on the
    current stream, so the copy queues behind the step in flight instead of
    waiting for it on the host.

    With a ``mesh`` only this rank's rows of each array are copied, marked
    as a ``LocalShard`` so that the train step does not slice them again:
    the rows of dim 0, or of dim 1 for the (K, B, ...) slabs of
    :func:`stack_batches` when ``kdisp > 1``. Every rank runs the same
    sampler from the same seed, so the ranks' rows together are the batch
    one process would draw."""
    device = torch.device(device)
    if device.type != "cuda":
        put = lambda a: torch.from_numpy(a).to(device)
    else:
        put = lambda a: torch.from_numpy(a).pin_memory().to(
            device, non_blocking=True)
    if check_mesh(mesh) is None:
        return lambda b: tuple(put(a) for a in b)

    def rows(a):
        if kdisp == 1:
            return shard_batch(mesh, a)
        return np.swapaxes(shard_batch(mesh, np.swapaxes(a, 0, 1)), 0, 1)

    return lambda b: tuple(
        put(np.ascontiguousarray(rows(a))).as_subclass(LocalShard) for a in b)


def stack_batches(gen, k: int):
    """Stack ``k`` consecutive (x, y) batches from ``gen`` into one
    (k, B, ...) slab pair, the feeder of ``steps_per_dispatch=k``
    (``trainer.make_multi_step``). Runs on the producer side (typically
    inside a :class:`Prefetcher` thread)."""
    while True:
        bs = [next(gen) for _ in range(k)]
        yield (np.stack([b[0] for b in bs]),
               np.stack([b[1] for b in bs]))


class Prefetcher:
    """Background-thread batch producer with a bounded queue.

    Depth 2 by default: one batch ready while the device works on the
    current one. ``put_fn`` runs on the producer thread.
    """

    def __init__(self, gen, put_fn=None, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._put = put_fn or (lambda x: x)
        self._err = None

        def run():
            try:
                for item in gen:
                    if self._stop.is_set():
                        return
                    self._q.put(self._put(item))
                self._q.put(None)  # clean exhaustion -> StopIteration
            except Exception as e:  # surfaced on the next __next__
                self._err = e
                self._q.put(None)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._q.put(None)  # keep the sentinel for further __next__ calls
            raise self._err or StopIteration
        return item

    def close(self):
        self._stop.set()
        # Drain so the producer can exit.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

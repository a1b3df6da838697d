"""Synthetic dataset fixtures: neurofinder-like HDF5, TIFF trees, spike
traces, a Keras-layout UNet2DS checkpoint.

Copy of ``deepcalcium_tpu.data.fixtures`` (numpy, h5py and PIL only, the
last two imported inside the functions that write with them), so that the
port exercises ingest -> fit -> predict -> submit without the JAX package
and without the Neurofinder download. A seed gives the same arrays as the
original. The generators write the HDF5 contracts:

- neuron datasets: ``series/{raw,mean,max}``, ``masks/{raw,max}``, file
  attr ``name``;
- spike datasets: ``traces`` (R, T) float, ``spikes`` (R, T) binary, attr
  ``name``;
- raw TIFF trees: ``<name>/images/*.tiff`` and
  ``<name>/regions/regions.json``, for the ingest pipeline itself.
"""

import json
import os

import numpy as np

__all__ = [
    "synthetic_neurons",
    "make_neurons_hdf5",
    "make_tiff_tree",
    "make_spikes_hdf5",
    "realistic_neurons",
    "realistic_movie",
    "make_realistic_hdf5",
    "make_keras_unet2ds_hdf5",
]


def synthetic_neurons(rng, shape=(96, 96), nb_neurons=8, radius=3, margin=6):
    """Non-overlapping square-ish neuron masks: (N, H, W) int8 + centers."""
    h, w = shape
    masks, centers = [], []
    attempts = 0
    while len(masks) < nb_neurons and attempts < 1000:
        attempts += 1
        cy = int(rng.integers(margin, h - margin))
        cx = int(rng.integers(margin, w - margin))
        if any(abs(cy - y) < 2 * radius + 3 and abs(cx - x) < 2 * radius + 3
               for y, x in centers):
            continue
        m = np.zeros(shape, np.int8)
        m[cy - radius : cy + radius + 1, cx - radius : cx + radius + 1] = 1
        masks.append(m)
        centers.append((cy, cx))
    return np.stack(masks), centers


def _movie_from_masks(rng, masks, nb_frames=64, base=100, amp=400):
    """Poisson background + flickering neuron activity, int16."""
    any_neuron = masks.max(axis=0).astype(np.float32)
    # Each neuron flickers with its own random on/off activity.
    act = rng.random((nb_frames, masks.shape[0])) > 0.5
    signal = np.einsum("tn,nhw->thw", act.astype(np.float32),
                       masks.astype(np.float32)) * amp
    noise = rng.poisson(base, (nb_frames,) + masks.shape[1:])
    return (noise + signal + any_neuron * 50).astype(np.int16)


def _write_contract_hdf5(path, name, movie, masks):
    """One writer for the neurofinder HDF5 contract (series/{raw,mean,max},
    masks/{raw,max}, attr name), shared by every fixture generator so the
    contract cannot diverge between them."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as fp:
        fp.attrs["name"] = name
        fp.create_dataset("series/raw", data=movie, dtype="int16")
        fp.create_dataset("series/mean",
                          data=movie.mean(axis=0).astype(np.float16),
                          dtype="float16")
        fp.create_dataset("series/max", data=movie.max(axis=0), dtype="int16")
        fp.create_dataset("masks/raw", data=masks, dtype="int8")
        fp.create_dataset("masks/max", data=masks.max(axis=0), dtype="int8")
    return path


def make_neurons_hdf5(path, name="synthetic.00.00", shape=(96, 96),
                      nb_frames=64, nb_neurons=8, seed=0):
    """Write a full neurofinder-contract HDF5; returns the path."""
    rng = np.random.default_rng(seed)
    masks, _ = synthetic_neurons(rng, shape, nb_neurons)
    movie = _movie_from_masks(rng, masks, nb_frames)

    return _write_contract_hdf5(path, name, movie, masks)


def make_tiff_tree(root, name="synthetic.00.00", shape=(48, 48), nb_frames=12,
                   nb_neurons=4, seed=0, test_set=False):
    """Write <root>/<name>/images/*.tiff (+ regions.json unless test_set)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    masks, _ = synthetic_neurons(rng, shape, nb_neurons)
    movie = _movie_from_masks(rng, masks, nb_frames)

    img_dir = os.path.join(root, name, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(nb_frames):
        Image.fromarray(movie[i].astype(np.int32), mode="I").save(
            os.path.join(img_dir, f"image{i:05d}.tiff"))

    if not test_set:
        regions = []
        for m in masks:
            yy, xx = np.where(m == 1)
            regions.append(
                {"coordinates": [[int(y), int(x)] for y, x in zip(yy, xx)]})
        reg_dir = os.path.join(root, name, "regions")
        os.makedirs(reg_dir, exist_ok=True)
        with open(os.path.join(reg_dir, "regions.json"), "w") as fp:
            json.dump(regions, fp)
    return os.path.join(root, name), movie, masks


def make_spikes_hdf5(path, name="spikes.synthetic", nb_traces=16,
                     trace_len=512, spike_rate=0.02, seed=0):
    """Calcium-like traces: exponential-decay kernel at spike times + noise."""
    rng = np.random.default_rng(seed)
    spikes = (rng.random((nb_traces, trace_len)) < spike_rate).astype(np.uint8)
    kernel = np.exp(-np.arange(40) / 8.0)
    traces = np.stack([np.convolve(s, kernel)[:trace_len] for s in spikes])
    traces = traces * 3.0 + rng.standard_normal((nb_traces, trace_len)) * 0.15

    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as fp:
        fp.attrs["name"] = name
        fp.create_dataset("traces", data=traces.astype(np.float64))
        fp.create_dataset("spikes", data=spikes)
    return path


def realistic_neurons(rng, shape=(256, 256), nb_neurons=40, r_lo=3, r_hi=7,
                      allow_touching=True):
    """Soft-disk neurons with varied radii; adjacent/touching pairs allowed
    (what the mask-summary erosion exists for). Returns (N, H, W) int8."""
    h, w = shape
    masks, centers = [], []
    attempts = 0
    while len(masks) < nb_neurons and attempts < 5000:
        attempts += 1
        r = int(rng.integers(r_lo, r_hi + 1))
        cy = int(rng.integers(r + 1, h - r - 1))
        cx = int(rng.integers(r + 1, w - r - 1))
        min_gap = 0 if allow_touching else 2
        if any((cy - y) ** 2 + (cx - x) ** 2 < (r + rr + min_gap) ** 2 * 0.5
               for y, x, rr in centers):
            continue
        yy, xx = np.mgrid[0:h, 0:w]
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
        masks.append(disk.astype(np.int8))
        centers.append((cy, cx, r))
    return np.stack(masks)


def realistic_movie(rng, masks, nb_frames=128, base=120, amp_lo=80,
                    amp_hi=300, decay=8.0, spike_rate=0.05):
    """Calcium-imaging-like movie: per-neuron Poisson spike trains convolved
    with an exponential calcium kernel, plus shot noise and slow background
    drift. int16 (T, H, W)."""
    n = masks.shape[0]
    kernel = np.exp(-np.arange(int(decay * 4)) / decay)
    spikes = rng.random((nb_frames, n)) < spike_rate
    act = np.stack([np.convolve(spikes[:, i].astype(np.float64), kernel)[:nb_frames]
                    for i in range(n)], axis=1)
    amps = rng.uniform(amp_lo, amp_hi, n)
    signal = np.einsum("tn,n,nhw->thw", act, amps, masks.astype(np.float64))
    drift = 1.0 + 0.1 * np.sin(
        np.linspace(0, 3 * np.pi, nb_frames))[:, None, None]
    lam = np.clip(base * drift + signal, 1, None)
    return rng.poisson(lam).astype(np.int16)


def make_realistic_hdf5(path, name, shape=(256, 256), nb_frames=128,
                        nb_neurons=40, seed=0, r_lo=3, r_hi=7,
                        amp_lo=80, amp_hi=300, spike_rate=0.05):
    """Realistic-synthetic neurofinder-contract HDF5 (harder than
    make_neurons_hdf5: soft disks, transients, drift, touching pairs).

    The density and SNR knobs (``nb_neurons``/``r_lo``/``r_hi``, ``amp_*``/
    ``spike_rate``) let sweeps match real-data difficulty: the Neurofinder
    train corpus averages 0.126 positive-pixel proportion, and fixtures far
    easier than that saturate model comparisons."""
    rng = np.random.default_rng(seed)
    masks = realistic_neurons(rng, shape, nb_neurons, r_lo=r_lo, r_hi=r_hi)
    movie = realistic_movie(rng, masks, nb_frames, amp_lo=amp_lo,
                            amp_hi=amp_hi, spike_rate=spike_rate)
    return _write_contract_hdf5(path, name, movie, masks)


def make_keras_unet2ds_hdf5(path, nfb=4, seed=0):
    """Synthesise a Keras-2.0.6-layout UNet2DS checkpoint (the save_model
    HDF5 structure: a model_weights group, layer_names / weight_names
    attrs) with random weights in Keras' shape conventions, for testing
    the migration path without the released weights."""
    import h5py

    from deepcalcium_torch.models.unet2d import (UNet2DS, layer_order,
                                                 to_jax_params)

    rng = np.random.default_rng(seed)
    # Keras' kernel shapes are the JAX layout's (HWIO; (p, q, o, c)).
    params, _ = to_jax_params(UNet2DS(nfb=nfb))

    counters = {"conv": 0, "tconv": 0, "bn": 0}
    layer_names, groups = [], {}
    for name, kind, cout in layer_order(nfb):
        if kind == "bn":
            counters["bn"] += 1
            lname = f"batch_normalization_{counters['bn']}"
            ws = {f"{lname}/gamma:0": np.ones((cout,), np.float32),
                  f"{lname}/beta:0": np.zeros((cout,), np.float32),
                  f"{lname}/moving_mean:0": np.zeros((cout,), np.float32),
                  f"{lname}/moving_variance:0": np.ones((cout,), np.float32)}
        else:
            key, prefix = (("tconv", "conv2d_transpose") if kind == "tconv"
                           else ("conv", "conv2d"))
            counters[key] += 1
            lname = f"{prefix}_{counters[key]}"
            ws = {f"{lname}/kernel:0": rng.standard_normal(
                      params[name]["kernel"].shape).astype(np.float32) * 0.05,
                  f"{lname}/bias:0": np.zeros((cout,), np.float32)}
        layer_names.append(lname)
        groups[lname] = ws

    with h5py.File(path, "w") as fp:
        fp.attrs["model_config"] = b"{}"
        mw = fp.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([n.encode() for n in layer_names])
        for lname in layer_names:
            g = mw.create_group(lname)
            ws = groups[lname]
            g.attrs["weight_names"] = np.array([w.encode() for w in ws])
            for wname, arr in ws.items():
                g.create_dataset(wname, data=arr)
    return path

"""Synthetic inputs, made from the run's seed: neuron masks, calcium
movies, summary images and spike traces.

The recipes are those of ``chip_smoke.py`` (itself from the JAX package's
``data/fixtures.py``): disk neurons of radius 3-7 px that may touch; a movie
of per-neuron spike trains (rate 0.05 a frame) through an exponential
calcium kernel (tau 8 frames), amplitudes 80-300 over a base of 120 with
a slow drift, and Poisson shot noise, as int16; spike traces of rate 0.02
through a tau-8 kernel, times 3, plus noise of std 0.15, z-normalised per
trace. Movies and summaries are made on the card in large calls."""

import math

import numpy as np
import torch
import torch.nn.functional as F


def neuron_masks(rng, shape, n, r_lo=3, r_hi=7):
    """(n, H, W) int8 disk masks at random centres, touching pairs
    allowed but no centre closer than about 0.7 radii to another."""
    h, w = shape
    masks = np.zeros((n, h, w), np.int8)
    cy = np.empty(0)
    cx = np.empty(0)
    cr = np.empty(0)
    k = 0
    for _ in range(50 * n):
        if k == n:
            break
        r = int(rng.integers(r_lo, r_hi + 1))
        y = int(rng.integers(r + 1, h - r - 1))
        x = int(rng.integers(r + 1, w - r - 1))
        if np.any((cy - y) ** 2 + (cx - x) ** 2 < (r + cr) ** 2 * 0.5):
            continue
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        masks[k, y - r:y + r + 1, x - r:x + r + 1] = (yy ** 2 + xx ** 2 <= r * r)
        cy, cx, cr = np.append(cy, y), np.append(cx, x), np.append(cr, r)
        k += 1
    return masks[:k]


def calcium_movie(masks, t, gen, device, base=120.0, amp=(80.0, 300.0),
                  decay=8.0, rate=0.05, chunk=500):
    """A (t, H, W) int16 movie on ``device`` of the neurons in ``masks``."""
    n = masks.shape[0]
    klen = int(decay * 4)
    kernel = torch.exp(-torch.arange(klen, device=device) / decay)
    spikes = torch.rand((n, 1, t), generator=gen, device=device) < rate
    act = F.conv1d(F.pad(spikes.float(), (klen - 1, 0)),
                   kernel.flip(0)[None, None])[:, 0]
    amps = amp[0] + (amp[1] - amp[0]) * torch.rand(n, generator=gen,
                                                    device=device)
    foot = torch.from_numpy(masks).to(device).reshape(n, -1).float()
    foot *= amps[:, None]
    drift = 1.0 + 0.1 * torch.sin(torch.linspace(0, 3 * math.pi, t,
                                                 device=device))
    movie = torch.empty((t,) + masks.shape[1:], dtype=torch.int16,
                        device=device)
    for i in range(0, t, chunk):
        lam = act[:, i:i + chunk].T @ foot + base * drift[i:i + chunk, None]
        lam = lam.clamp_min(1.0).reshape((-1,) + masks.shape[1:])
        movie[i:i + chunk] = torch.poisson(lam, generator=gen).to(torch.int16)
    return movie


def summary_image(masks, t, gen, device, base=120.0, amp=(80.0, 300.0),
                  decay=8.0, rate=0.05):
    """The z-normalised (H, W) float32 mean image a ``t``-frame movie of
    :func:`calcium_movie` would give, made directly: each neuron's mean
    activity (its spike count through the kernel over t frames), its
    amplitude, the drift's mean and the shot noise of a t-frame mean."""
    n = masks.shape[0]
    per_spike = float(sum(math.exp(-i / decay) for i in range(int(decay * 4))))
    count = torch.poisson(torch.full((n,), rate * t, device=device),
                          generator=gen)
    amps = amp[0] + (amp[1] - amp[0]) * torch.rand(n, generator=gen,
                                                    device=device)
    level = count * per_spike / t * amps
    foot = torch.from_numpy(masks).to(device).reshape(n, -1).float()
    drift = 1.0 + 0.1 * torch.sin(torch.linspace(0, 3 * math.pi, t,
                                                 device=device)).mean()
    lam = (level @ foot + base * drift).reshape(masks.shape[1:])
    mean = lam + torch.randn(lam.shape, generator=gen, device=device) * (
        lam / t).sqrt()
    return ((mean - mean.mean()) / mean.std(correction=0)).cpu().numpy()


def spike_traces(rng, n, t, rate=0.02):
    """(traces float32 (n, t) z-normalised per trace, spikes uint8 (n, t))."""
    spikes = (rng.random((n, t)) < rate).astype(np.uint8)
    kernel = np.exp(-np.arange(40) / 8.0)
    traces = np.stack([np.convolve(s, kernel)[:t] for s in spikes]) * 3.0
    traces += rng.standard_normal((n, t)) * 0.15
    traces = (traces - traces.mean(axis=1, keepdims=True)) / traces.std(
        axis=1, keepdims=True)
    return traces.astype(np.float32), spikes


def spread(values, rng):
    """A fixed set of sizes in an order of the seed's."""
    return [values[i] for i in rng.permutation(len(values))]

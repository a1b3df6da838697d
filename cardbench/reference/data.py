"""What the wrappers derive from their inputs on the host, worked out
again: the mask summary of a stack of neuron masks, the neuron-centred 2-D
training windows, the spike fit's split and windows, and the margin-pooled
spike labels. Each is the documented recipe with the same draws from the
same seeded numpy generator, so the windows a fit trains on are known from
its seed and its data alone."""

from itertools import cycle
from math import ceil

import numpy as np

_NBRS = [(-1, 0), (1, 0), (0, -1), (0, 1), (1, 1), (-1, -1), (1, -1),
         (-1, 1), (0, 0)]


def mask_summary(msks):
    """(N, H, W) binary neuron masks -> (H, W) float64 target: pixels of
    exactly one neuron, walked in (neuron, row, column) discovery order;
    where a pixel's surviving 3x3 neighbourhood holds two neuron ids, that
    neighbourhood is deleted, and later steps see the deletion."""
    zz, yy, xx = np.where(np.asarray(msks) == 1)
    counts = {}
    for z, y, x in zip(zz.tolist(), yy.tolist(), xx.tolist()):
        counts.setdefault((y, x), []).append(z)
    owner = {k: v[0] for k, v in counts.items() if len(v) == 1}
    for y, x in list(owner):
        nb = [(y + dy, x + dx) for dy, dx in _NBRS if (y + dy, x + dx) in owner]
        if nb and len({owner[k] for k in nb}) > 1:
            for k in nb:
                del owner[k]
    out = np.zeros(np.shape(msks)[1:], np.float64)
    if owner:
        ys, xs = zip(*owner)
        out[list(ys), list(xs)] = 1.0
    return out


# The dihedral group D4 on (H, W) arrays, codes in the wrappers' order, its
# table (D4[a, b] = a after b) and the training walk's generators.
_D4 = [lambda a: a, lambda a: a[::-1, :], lambda a: a[:, ::-1],
       lambda a: np.rot90(a, 1), lambda a: np.rot90(a, 2),
       lambda a: np.rot90(a, 3), lambda a: np.rot90(a, 1)[::-1, :],
       lambda a: np.rot90(a, 1)[:, ::-1]]
D4 = np.array([[0, 1, 2, 3, 4, 5, 6, 7], [1, 0, 4, 6, 2, 7, 3, 5],
               [2, 4, 0, 7, 1, 6, 5, 3], [3, 7, 6, 4, 5, 0, 1, 2],
               [4, 2, 1, 5, 0, 3, 7, 6], [5, 6, 7, 0, 3, 4, 2, 1],
               [6, 5, 3, 2, 7, 1, 0, 4], [7, 3, 5, 1, 6, 2, 4, 0]])
_WALK = np.array([0, 2, 1, 3, 4, 5])  # identity, hflip, vflip, rot90/180/270


def neuron_windows(S, M, y_bands, window, batch, nb_batches, nb_max_augment,
                   seed):
    """The first ``nb_batches`` training batches of the 2-D fit: a dataset
    drawn among those with neuron pixels in their training band, a window
    centred on one of them with +-5 px of jitter (zero outside the image),
    and a random walk of up to ``nb_max_augment`` D4 generators. Returns
    a list of (x (B, h, w) float32, y (B, h, w) float32)."""
    rng = np.random.default_rng(seed)
    S = [np.asarray(s, np.float32) for s in S]
    M = [np.asarray(m, np.uint8) for m in M]
    locs = []
    for m, (y0, y1) in zip(M, y_bands):
        yy, xx = np.where(m[y0:y1, :] == 1)
        locs.append(np.stack([yy + y0, xx], axis=1))
    valid = np.array([len(l) > 0 for l in locs])
    probs = valid / valid.sum()
    hw, ww = window
    out = []
    for _ in range(nb_batches):
        xb = np.zeros((batch, hw, ww), np.float32)
        yb = np.zeros((batch, hw, ww), np.uint8)
        for b in range(batch):
            ds = int(rng.choice(len(S), p=probs))
            s, m = S[ds], M[ds]
            ymin, ymax = y_bands[ds]
            cy, cx = locs[ds][int(rng.integers(0, len(locs[ds])))]
            cy = min(max(ymin, cy + int(rng.integers(-5, 5))), ymax)
            cx = min(max(0, cx + int(rng.integers(-5, 5))), s.shape[1])
            y0 = max(ymin, int(cy - hw // 2))
            y1 = min(y0 + hw, ymax)
            x0 = max(0, int(cx - ww // 2))
            x1 = min(x0 + ww, s.shape[1])
            xb[b, :y1 - y0, :x1 - x0] = s[y0:y1, x0:x1]
            yb[b, :y1 - y0, :x1 - x0] = m[y0:y1, x0:x1]
            code = 0
            for _ in range(int(rng.integers(0, nb_max_augment + 1))):
                code = int(D4[_WALK[int(rng.integers(0, len(_WALK)))], code])
            if code:
                xb[b] = _D4[code](xb[b])
                yb[b] = _D4[code](yb[b])
        out.append((xb, yb.astype(np.float32)))
    return out


def margin_labels(spikes, margin):
    """Spike labels widened by a SAME max-pool over ``margin + 1``
    samples, float32."""
    x = np.asarray(spikes, np.float32)
    if margin <= 0:
        return x
    w = margin + 1
    lo = (w - 1) // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(lo, w - 1 - lo)],
                constant_values=-np.inf)
    return np.lib.stride_tricks.sliding_window_view(xp, w, axis=-1).max(-1)


def spike_split(n, prop_trn, seed):
    """(train indices, validation indices) of the random split."""
    idxs = np.random.default_rng(seed).permutation(n)
    n_trn = int(n * prop_trn)
    return idxs[:n_trn], idxs[n_trn:]


def spike_windows(traces, spikes, wlen, batch, margin, nb_batches, seed):
    """The first ``nb_batches`` batches of the spike fit's window stream
    over ``traces`` (a list of 1-D arrays): each pass visits the traces in
    a fresh random order, ``ceil(n / batch)`` batches a pass, a random
    window of each (zero-padded when the trace is shorter)."""
    rng = np.random.default_rng(seed)
    labels = [margin_labels(s[None], margin)[0] for s in spikes]
    out = []
    while len(out) < nb_batches:
        order = cycle(rng.permutation(len(traces)))
        for _ in range(max(1, int(ceil(len(traces) / batch)))):
            tb = np.zeros((batch, wlen), np.float32)
            sb = np.zeros((batch, wlen), np.float32)
            for b in range(batch):
                i = next(order)
                t, s = traces[i], labels[i]
                if len(t) <= wlen:
                    tb[b, :len(t)] = t
                    sb[b, :len(s)] = s
                else:
                    x0 = int(rng.integers(0, len(t) - wlen))
                    tb[b] = t[x0:x0 + wlen]
                    sb[b] = s[x0:x0 + wlen]
            out.append((tb, sb))
            if len(out) == nb_batches:
                break
    return out

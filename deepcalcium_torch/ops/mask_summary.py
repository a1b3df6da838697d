"""Mask summary: flatten N per-neuron masks to one 2-D mask, erasing pixels
where different neurons touch or overlap.

A numpy copy of ``deepcalcium_tpu.ops.mask_summary.mask_summary_exact``
(that module imports JAX at the top, so the port cannot import it). It runs
once per dataset on the host, for ground-truth scoring.
"""

import numpy as np

__all__ = ["mask_summary_exact"]

_NBRS = [(-1, 0), (1, 0), (0, -1), (0, 1), (1, 1), (-1, -1), (1, -1), (-1, 1)]


def mask_summary_exact(msks: np.ndarray) -> np.ndarray:
    """Sequential mask summary, in the reference's iteration order.

    1. Keep only pixels covered by exactly one neuron.
    2. Walk those pixels in z-major discovery order; where a pixel's
       surviving 3x3 neighbourhood holds more than one neuron id, delete the
       whole surviving neighbourhood. Deletions are seen by later steps.

    # Arguments
        msks: (N, H, W) stack of binary per-neuron masks.

    # Returns
        (H, W) float64 array with 1.0 at surviving pixels.
    """
    msks = np.asarray(msks)
    zz, yy, xx = np.where(msks == 1)

    counts: dict = {}
    for z, y, x in zip(zz.tolist(), yy.tolist(), xx.tolist()):
        counts.setdefault((y, x), []).append(z)
    yx_z = {k: v[0] for k, v in counts.items() if len(v) == 1}

    for y, x in list(yx_z.keys()):
        nbrs = [(y + dy, x + dx) for dy, dx in _NBRS + [(0, 0)]
                if (y + dy, x + dx) in yx_z]
        if not nbrs:
            continue
        if len({yx_z[k] for k in nbrs}) > 1:
            for k in nbrs:
                del yx_z[k]

    summ = np.zeros(msks.shape[1:], dtype=np.float64)
    if yx_z:
        ys, xs = zip(*yx_z.keys())
        summ[list(ys), list(xs)] = 1.0
    return summ

"""Neurofinder challenge metrics for 2-D binary masks, on the host.

Port of ``deepcalcium_tpu.metrics.neurofinder`` (numpy and scipy only), so
that the port scores its masks without importing the JAX package. Same
semantics:

- regions are the 8-connected components of a mask, in label order; a
  region's center is the mean of its pixel coordinates;
- ground-truth regions are matched in order to the nearest remaining
  predicted center, closer than ``threshold`` (unbounded by default);
- recall = matched / |truth|, precision = matched / |prediction|;
  inclusion and exclusion are |a ∩ b| / |a| and |a ∩ b| / |b| averaged over
  matched pairs.
"""

import numpy as np
from scipy import ndimage

__all__ = ["label_mask", "mask_to_regions", "centers", "shapes",
           "nf_mask_metrics"]

_STRUCT8 = np.ones((3, 3), dtype=np.int32)


def label_mask(m: np.ndarray) -> np.ndarray:
    """8-connected component labeling of a binary 2-D mask."""
    labeled, _ = ndimage.label(np.asarray(m) > 0, structure=_STRUCT8)
    return labeled


def mask_to_regions(m: np.ndarray) -> list:
    """Binary 2-D mask -> list of (N, 2) int64 coordinate arrays, one per
    8-connected component, in label order."""
    labeled = label_mask(m)
    regions = []
    for lbl, sl in enumerate(ndimage.find_objects(labeled), start=1):
        if sl is None:
            continue
        yy, xx = np.nonzero(labeled[sl] == lbl)
        regions.append(np.stack([yy + sl[0].start, xx + sl[1].start],
                                axis=1).astype(np.int64))
    return regions


def _match(a, b, threshold):
    """For each region of ``a`` in order: the index of the nearest
    remaining center of ``b`` closer than ``threshold``, else None."""
    if not b:
        return [None] * len(a)
    targets = np.stack([r.mean(axis=0) for r in b])
    alive = np.ones(len(b), dtype=bool)
    out = []
    for ra in a:
        if not alive.any():
            out.append(None)
            continue
        d = np.linalg.norm(targets - ra.mean(axis=0), axis=1)
        d[~alive] = np.inf
        i = int(np.argmin(d))
        if d[i] < threshold:
            out.append(i)
            alive[i] = False
        else:
            out.append(None)
    return out


def centers(a, b, threshold=np.inf):
    """(recall, precision) of the center matching of ``b`` to truth ``a``."""
    n = sum(i is not None for i in _match(a, b, threshold))
    return (n / float(len(a)) if a else 0.0,
            n / float(len(b)) if b else 0.0)


def shapes(a, b, threshold=np.inf):
    """(inclusion, exclusion) averaged over matched pairs."""
    incl, excl = [], []
    for j, i in enumerate(_match(a, b, threshold)):
        if i is None:
            continue
        inter = len({tuple(c) for c in a[j].tolist()}
                    & {tuple(c) for c in b[i].tolist()})
        incl.append(inter / float(len(a[j])))
        excl.append(inter / float(len(b[i])))
    if not incl:
        return 0.0, 0.0
    return float(np.mean(incl)), float(np.mean(excl))


def nf_mask_metrics(m, mp, threshold=np.inf):
    """(precision, recall, inclusion, exclusion, F1) of predicted mask
    ``mp`` (rounded to 0/1) against ground truth ``m``; all zeros for an
    empty prediction."""
    mp = np.round(np.asarray(mp))
    if np.sum(mp) == 0:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    ra, rb = mask_to_regions(m), mask_to_regions(mp)
    r, p = centers(ra, rb, threshold)
    i, e = shapes(ra, rb, threshold)
    f1 = 2.0 * (r * p) / (r + p) if (r + p) > 0 else 0.0
    return p, r, i, e, f1

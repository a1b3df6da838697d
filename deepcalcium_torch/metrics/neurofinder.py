"""Neurofinder challenge metrics for 2-D binary masks, on the host.

Port of ``deepcalcium_tpu.metrics.neurofinder`` (numpy and scipy only), so
that the port scores its masks without importing the JAX package. Same
semantics:

- regions are the 8-connected components of a mask, in label order, held
  as (N, 2) coordinate arrays (or :class:`Region` objects, which cache
  their center); a region's center is the mean of its pixel coordinates;
- ground-truth regions are matched in order to the nearest remaining
  predicted center, closer than ``threshold`` (unbounded by default);
- recall = matched / |truth|, precision = matched / |prediction|;
  inclusion and exclusion are |a ∩ b| / |a| and |a ∩ b| / |b| averaged over
  matched pairs.
"""

import numpy as np
from scipy import ndimage

__all__ = ["Region", "label_mask", "mask_to_regions", "regions_to_mask",
           "match_centers", "centers", "shapes", "nf_mask_metrics"]

_STRUCT8 = np.ones((3, 3), dtype=np.int32)


class Region:
    """A set of pixel coordinates with its cached center (their mean)."""

    __slots__ = ("coordinates", "center")

    def __init__(self, coordinates):
        self.coordinates = np.asarray(coordinates, dtype=np.int64)
        if self.coordinates.ndim != 2 or self.coordinates.shape[1] != 2:
            raise ValueError("coordinates must be (N, 2)")
        self.center = self.coordinates.mean(axis=0)

    def __len__(self):
        return len(self.coordinates)


def _coords(region) -> np.ndarray:
    return region.coordinates if isinstance(region, Region) else region


def _center(region) -> np.ndarray:
    return (region.center if isinstance(region, Region)
            else region.mean(axis=0))


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


def regions_to_mask(regions, shape) -> np.ndarray:
    """List of regions -> binary 2-D uint8 mask."""
    m = np.zeros(shape, dtype=np.uint8)
    for r in regions:
        c = _coords(r)
        m[c[:, 0], c[:, 1]] = 1
    return m


def match_centers(a, b, threshold=np.inf):
    """Greedy sequential center matching: for each region of ``a`` in
    order, the index of the nearest remaining center of ``b`` closer than
    ``threshold``, else None."""
    if len(b) == 0:
        return [None] * len(a)
    targets = np.stack([_center(r) for r in b])
    alive = np.ones(len(b), dtype=bool)
    out = []
    for ra in a:
        if not alive.any():
            out.append(None)
            continue
        d = np.linalg.norm(targets - _center(ra), axis=1)
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
    n = sum(i is not None for i in match_centers(a, b, threshold))
    return (n / float(len(a)) if a else 0.0,
            n / float(len(b)) if b else 0.0)


def shapes(a, b, threshold=np.inf):
    """(inclusion, exclusion) averaged over matched pairs."""
    incl, excl = [], []
    for j, i in enumerate(match_centers(a, b, threshold)):
        if i is None:
            continue
        inter = len({tuple(c) for c in _coords(a[j]).tolist()}
                    & {tuple(c) for c in _coords(b[i]).tolist()})
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

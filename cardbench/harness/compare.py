"""The numbers that decide ``correct``: each a gap between what the
measured package produced and what the reference works out, held to a
limit of its own (``cardbench/limits/<workload>.json``)."""

import numpy as np
import torch


def prob_gap(prob, ref_prob):
    """Largest absolute gap between two probability maps."""
    return float(np.max(np.abs(np.asarray(prob, np.float64)
                               - np.asarray(ref_prob, np.float64))))


def flip_margin(mask, ref_prob, threshold):
    """Largest distance from the threshold of the reference's probability
    at a pixel or sample where the mask disagrees with the reference's
    (0 where they agree everywhere): a disagreement is sound only where
    the reference itself lies close to the threshold."""
    ref_prob = np.asarray(ref_prob, np.float64)
    off = np.asarray(mask).astype(bool) != (ref_prob > threshold)
    if not off.any():
        return 0.0
    return float(np.max(np.abs(ref_prob[off] - threshold)))


def flip_share(mask, ref_prob, threshold):
    """Share of the pixels or samples whose mask disagrees with the
    reference's ``ref_prob > threshold``."""
    off = np.asarray(mask).astype(bool) != (np.asarray(ref_prob) > threshold)
    return float(off.mean())


def leaf_gaps(prog, ref, keep=None):
    """``{leaf: |norm(prog[k]) - norm(ref[k])| / max(norm(ref[k]), the
    median leaf's norm)}`` over the leaves ``keep`` (all by default)."""
    keys = list(keep if keep is not None else ref)
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median(list(rn.values())))
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k])
            / max(rn[k], med) for k in keys}


def unexplained_flips(mask, ref_prob, threshold, margin):
    """Pixels whose mask disagrees with the reference's where the
    reference's probability lies farther than ``margin`` from the
    threshold: a probability within ``margin`` of the reference's cannot
    cross the threshold there, so such a pixel is a wrong mask."""
    ref_prob = np.asarray(ref_prob, np.float64)
    off = np.asarray(mask).astype(bool) != (ref_prob > threshold)
    return int(np.count_nonzero(off & (np.abs(ref_prob - threshold) > margin)))


def moving_leaves(grads, rel=1e-3):
    """The leaves whose reference gradient is above ``rel`` times the
    median leaf's: a gradient under it is nought to rounding (a conv bias
    under a training-mode BN), and Adam moves such a leaf by round-off
    alone."""
    n = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= rel * med]

"""Segmentation losses and metrics on tensors.

Port of ``deepcalcium_tpu.ops.losses``, with its conventions kept:

- ``EPS = 1e-7`` plays the role of Keras' ``K.epsilon()``.
- Sums are global over the whole batch tensor, so precision, recall and F1
  are batch aggregates, not means over samples.
- ``torch.round`` rounds half to even, as ``jnp.round`` does, so a
  probability of exactly 0.5 counts as negative in both packages.

The ``*_loss`` functions do not round and are differentiable.
"""

import torch

__all__ = ["EPS", "LOSSES", "NEURON_METRICS", "SPIKE_METRICS"]

EPS = 1e-7  # K.epsilon() in Keras 2.0.6.


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def binary_crossentropy(yt, yp):
    """Keras ``binary_crossentropy``: elementwise BCE of the clipped
    prediction, mean over the last axis."""
    ypc = torch.clamp(yp, EPS, 1.0 - EPS)
    bce = -(yt * torch.log(ypc) + (1.0 - yt) * torch.log(1.0 - ypc))
    return bce.mean(dim=-1)


def weighted_binary_crossentropy(yt, yp, weightpos=2.0, weightneg=1.0):
    """Class-weighted BCE with ``log(x + 1e-7)``."""
    losspos = yt * torch.log(yp + 1e-7)
    lossneg = (1.0 - yt) * torch.log(1.0 - yp + 1e-7)
    return -1.0 * (weightpos * losspos + weightneg * lossneg)


def jacc_loss(yt, yp):
    """Smooth (unrounded) Jaccard loss."""
    inter = torch.sum(yt * yp)
    union = torch.sum(yt) + torch.sum(yp) - inter
    return 1.0 - inter / (union + 1e-7)


def dice_loss(yt, yp):
    """Smooth dice loss."""
    inter = torch.sum(yt * yp)
    return 1.0 - (2.0 * inter) / (torch.sum(yt) + torch.sum(yp) + 1e-7)


def dicesq_loss(yt, yp):
    """Negated squared-denominator dice."""
    return -1.0 * dicesq(yt, yp)


# ---------------------------------------------------------------------------
# Metrics (2-D neurons)
# ---------------------------------------------------------------------------

def prec(yt, yp):
    """Batch-aggregate pixel precision."""
    ypr = torch.round(yp)
    return torch.sum(ypr * yt) / (torch.sum(ypr) + EPS)


def reca(yt, yp):
    """Batch-aggregate pixel recall."""
    ypr = torch.round(yp)
    tp = torch.sum(ypr * yt)
    fn = torch.sum(torch.clamp(yt - ypr, 0.0, 1.0))
    return tp / (tp + fn + EPS)


def F1(yt, yp):
    """Pixelwise F1 from the aggregate precision and recall."""
    p = prec(yt, yp)
    r = reca(yt, yp)
    return (2.0 * p * r) / (p + r + EPS)


def jacc(yt, yp):
    """Rounded Jaccard coefficient."""
    ypr = torch.round(yp)
    inter = torch.sum(yt * ypr)
    union = torch.sum(yt) + torch.sum(ypr) - inter
    return inter / (union + 1e-7)


def dice(yt, yp):
    """Rounded dice coefficient."""
    ypr = torch.round(yp)
    inter = torch.sum(yt * ypr)
    return (2.0 * inter) / (torch.sum(yt) + torch.sum(ypr) + 1e-7)


def dicesq(yt, yp):
    """Squared-denominator dice, unrounded (a metric, and negated a loss)."""
    nmr = 2.0 * torch.sum(yt * yp)
    dnm = torch.sum(yt**2) + torch.sum(yp**2) + EPS
    return nmr / dnm


def posyt(yt, yp):
    """Positive-pixel share of the ground truth."""
    return torch.sum(yt) / (yt.numel() + EPS)


def posyp(yt, yp):
    """Positive-pixel share of the rounded prediction."""
    return torch.sum(torch.round(yp)) / (yp.numel() + EPS)


# ---------------------------------------------------------------------------
# Metrics (1-D spikes)
# ---------------------------------------------------------------------------

def F2(yt, yp, beta=2.0):
    """Recall-weighted F-beta (beta=2)."""
    p = prec(yt, yp)
    r = reca(yt, yp)
    return (1.0 + beta**2) * ((p * r) / (beta**2 * p + r + EPS))


def ytspks(yt, yp):
    """Spike count of each ground-truth row."""
    return torch.sum(yt, dim=1)


def ypspks(yt, yp):
    """Spike count of each rounded prediction row."""
    return torch.sum(torch.round(yp), dim=1)


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

LOSSES = {
    "binary_crossentropy": binary_crossentropy,
    "weighted_binary_crossentropy": weighted_binary_crossentropy,
    "dice_loss": dice_loss,
    "dicesq_loss": dicesq_loss,
}

NEURON_METRICS = {
    "F1": F1,
    "prec": prec,
    "reca": reca,
    "dice": dice,
    "dicesq": dicesq,
    "posyt": posyt,
    "posyp": posyp,
}

SPIKE_METRICS = {
    "F2": F2,
    "prec": prec,
    "reca": reca,
    "ytspks": lambda yt, yp: torch.mean(ytspks(yt, yp)),
    "ypspks": lambda yt, yp: torch.mean(ypspks(yt, yp)),
}

"""Segmentation losses and metrics on tensors.

Port of ``deepcalcium_tpu.ops.losses``, with its conventions kept:

- ``EPS = 1e-7`` plays the role of Keras' ``K.epsilon()``.
- Sums are global over the whole batch tensor, so precision, recall and F1
  are batch aggregates, not means over samples.
- ``torch.round`` rounds half to even, as ``jnp.round`` does, so a
  probability of exactly 0.5 counts as negative in both packages.

The ``*_loss`` functions do not round and are differentiable.

Every function whose sums run over the batch takes ``mesh`` (a
``parallel.mesh.Mesh``): ``yt`` and ``yp`` are then this rank's shard, and
each sum is all-reduced over the ranks, differentiably, so that the value is
the global batch's on every rank, as GSPMD makes it in the JAX package.
``jacc_loss``, ``dice_loss`` and ``dicesq_loss`` are not linear in their
sums: a mean of per-rank losses would be another number. The elementwise
losses and the per-row counts take no mesh; the train step averages them
over the global batch (:func:`with_mesh`, ``train.trainer``).
"""

import functools
import inspect

import torch

from deepcalcium_torch.parallel.mesh import psum

__all__ = ["EPS", "LOSSES", "NEURON_METRICS", "SPIKE_METRICS", "with_mesh"]

EPS = 1e-7  # K.epsilon() in Keras 2.0.6.


def _sum(x, mesh=None):
    """The sum of ``x``; over every rank's ``x`` under a mesh."""
    s = torch.sum(x)
    return s if mesh is None else psum(s, mesh)


def with_mesh(fn, mesh):
    """``fn(yt, yp)`` with ``mesh`` bound where ``fn`` takes one (also
    through a ``functools.partial``). A function without a ``mesh``
    argument is per sample (elementwise, or a value for each row), and is
    returned as it is: its mean over the global batch is the caller's."""
    if mesh is None:
        return fn
    try:
        takes = "mesh" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # a callable without a signature
        takes = False
    return functools.partial(fn, mesh=mesh) if takes else fn


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


def jacc_loss(yt, yp, mesh=None):
    """Smooth (unrounded) Jaccard loss."""
    inter = _sum(yt * yp, mesh)
    union = _sum(yt, mesh) + _sum(yp, mesh) - inter
    return 1.0 - inter / (union + 1e-7)


def dice_loss(yt, yp, mesh=None):
    """Smooth dice loss."""
    inter = _sum(yt * yp, mesh)
    return 1.0 - (2.0 * inter) / (_sum(yt, mesh) + _sum(yp, mesh) + 1e-7)


def dicesq_loss(yt, yp, mesh=None):
    """Negated squared-denominator dice."""
    return -1.0 * dicesq(yt, yp, mesh)


# ---------------------------------------------------------------------------
# Metrics (2-D neurons)
# ---------------------------------------------------------------------------

def prec(yt, yp, mesh=None):
    """Batch-aggregate pixel precision."""
    ypr = torch.round(yp)
    return _sum(ypr * yt, mesh) / (_sum(ypr, mesh) + EPS)


def reca(yt, yp, mesh=None):
    """Batch-aggregate pixel recall."""
    ypr = torch.round(yp)
    tp = _sum(ypr * yt, mesh)
    fn = _sum(torch.clamp(yt - ypr, 0.0, 1.0), mesh)
    return tp / (tp + fn + EPS)


def F1(yt, yp, mesh=None):
    """Pixelwise F1 from the aggregate precision and recall."""
    p = prec(yt, yp, mesh)
    r = reca(yt, yp, mesh)
    return (2.0 * p * r) / (p + r + EPS)


def jacc(yt, yp, mesh=None):
    """Rounded Jaccard coefficient."""
    ypr = torch.round(yp)
    inter = _sum(yt * ypr, mesh)
    union = _sum(yt, mesh) + _sum(ypr, mesh) - inter
    return inter / (union + 1e-7)


def dice(yt, yp, mesh=None):
    """Rounded dice coefficient."""
    ypr = torch.round(yp)
    inter = _sum(yt * ypr, mesh)
    return (2.0 * inter) / (_sum(yt, mesh) + _sum(ypr, mesh) + 1e-7)


def dicesq(yt, yp, mesh=None):
    """Squared-denominator dice, unrounded (a metric, and negated a loss)."""
    nmr = 2.0 * _sum(yt * yp, mesh)
    dnm = _sum(yt**2, mesh) + _sum(yp**2, mesh) + EPS
    return nmr / dnm


def _numel(x, mesh=None):
    """Elements of the global batch: the ranks' shards are equally large."""
    return x.numel() * (1 if mesh is None else mesh.size)


def posyt(yt, yp, mesh=None):
    """Positive-pixel share of the ground truth."""
    return _sum(yt, mesh) / (_numel(yt, mesh) + EPS)


def posyp(yt, yp, mesh=None):
    """Positive-pixel share of the rounded prediction."""
    return _sum(torch.round(yp), mesh) / (_numel(yp, mesh) + EPS)


# ---------------------------------------------------------------------------
# Metrics (1-D spikes)
# ---------------------------------------------------------------------------

def F2(yt, yp, beta=2.0, mesh=None):
    """Recall-weighted F-beta (beta=2)."""
    p = prec(yt, yp, mesh)
    r = reca(yt, yp, mesh)
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

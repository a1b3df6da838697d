"""Inference building blocks of the U-Net family, on NCHW tensors.

Port of ``deepcalcium_tpu.models.blocks`` (inference forms only). Semantics
follow Keras 2.0.6 defaults as the JAX package does: SAME stride-1 convs
with bias, k=s=2 transpose convs, 2x2 max-pool, and eval-mode BatchNorm with
``eps=1e-3``.

``dtype`` is the compute dtype, as in the JAX package: when set, the input,
kernel and bias are cast to it, the conv runs in it, and eval-mode BN runs
in it with its float32 statistics cast down. Parameters stay float32.
"""

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BN_EPS", "Conv2d", "ConvTranspose2x2", "BatchNorm", "conv2d",
           "tconv2x2", "maxpool2", "batch_norm", "he_normal_"]

BN_EPS = 1e-3  # Keras 2.0.6 BatchNormalization default epsilon.


def he_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """Keras-2.0.6 ``he_normal``: a standard normal truncated at +-2 sigma,
    scaled by sqrt(2 / fan_in), with no truncation-variance correction
    (``deepcalcium_tpu.models.blocks._truncated_normal``)."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_((2.0 / fan_in) ** 0.5)
    return w


def _cast(dtype, *ts):
    return ts if dtype is None else tuple(t.to(dtype) for t in ts)


def conv2d(x, weight, bias, dtype=None):
    """SAME stride-1 conv: (B, Cin, H, W) x OIHW (odd k) -> (B, Cout, H, W).
    The bias is added after the conv, in the compute dtype, as
    ``conv_general_dilated(...) + b`` does in the JAX package."""
    x, weight, bias = _cast(dtype, x, weight, bias)
    y = F.conv2d(x, weight, None, padding=weight.shape[-1] // 2)
    return y + bias[:, None, None]


def tconv2x2(x, weight, bias, dtype=None):
    """Conv2DTranspose(k=2, s=2, VALID) with a (Cin, Cout, 2, 2) kernel:
    out[b, o, 2i+p, 2j+q] = sum_c x[b, c, i, j] * weight[c, o, p, q] + bias[o]."""
    x, weight, bias = _cast(dtype, x, weight, bias)
    y = F.conv_transpose2d(x, weight, None, stride=2)
    return y + bias[:, None, None]


def maxpool2(x):
    """MaxPooling2D(2, strides=2)."""
    return F.max_pool2d(x, 2)


def batch_norm(x, gamma, beta, mean, var):
    """Eval-mode Keras BN over channels (dim 1). The scale is formed in
    float32 and cast to ``x.dtype`` with the statistics, as in the JAX
    package's ``batch_norm(train=False)``."""
    inv = torch.rsqrt(var + BN_EPS) * gamma
    dt = x.dtype
    return ((x - mean.to(dt)[:, None, None]) * inv.to(dt)[:, None, None]
            + beta.to(dt)[:, None, None])


class Conv2d(nn.Module):
    """SAME conv holder: ``weight`` OIHW, ``bias`` (Cout,)."""

    def __init__(self, cin, cout, k, generator):
        super().__init__()
        self.weight = nn.Parameter(he_normal_(torch.empty(cout, cin, k, k),
                                              cin * k * k, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, dtype=None):
        return conv2d(x, self.weight, self.bias, dtype)


class ConvTranspose2x2(nn.Module):
    """k=s=2 transpose conv holder: ``weight`` (Cin, Cout, 2, 2).

    he_normal fan_in is 4 * Cout, the Keras quirk the JAX package keeps
    (``blocks.init_tconv``: Keras reads fans off the raw HWOI shape)."""

    def __init__(self, cin, cout, generator):
        super().__init__()
        self.weight = nn.Parameter(he_normal_(torch.empty(cin, cout, 2, 2),
                                              4 * cout, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, dtype=None):
        return tconv2x2(x, self.weight, self.bias, dtype)


class BatchNorm(nn.Module):
    """Eval-mode BN: ``weight``/``bias`` are Keras gamma/beta, the buffers
    ``running_mean``/``running_var`` its moving statistics."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var)

"""Building blocks of the U-Net family, on channels-first tensors: NCHW
for the 2-D net, NCW for the 1-D one.

Port of ``deepcalcium_tpu.models.blocks``. Semantics follow Keras 2.0.6
defaults as the JAX package does: SAME stride-1 convs with bias, k=s=2
transpose convs, 2x2 and window-2 max-pools, the 1-D net's SAME margin
max-pool and repeat upsampling, BatchNorm with ``eps=1e-3`` and inverted
dropout.

``dtype`` is the compute dtype, as in the JAX package: when set, the input,
kernel and bias are cast to it, the conv runs in it, and BN normalises in it
with its float32 statistics cast down. Parameters stay float32.

Train-mode BN is written out here rather than taken from
``F.batch_norm``: the Keras running update uses the biased batch variance,
and ``F.batch_norm`` updates ``running_var`` with the unbiased one.
"""

import torch
import torch.nn.functional as F
from torch import nn

from deepcalcium_torch.parallel.mesh import psum

__all__ = ["BN_EPS", "Conv2d", "Conv1d", "ConvTranspose2x2", "BatchNorm",
           "conv2d", "conv1d", "tconv2x2", "maxpool2", "pool2",
           "maxpool1d_same", "upsample1d", "batch_norm", "batch_stats",
           "dropout", "dropout_with_mask", "he_normal_", "kernel_init_",
           "INIT_SCHEMES"]

BN_EPS = 1e-3  # Keras 2.0.6 BatchNormalization default epsilon.


def he_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """Keras-2.0.6 ``he_normal``: a standard normal truncated at +-2 sigma,
    scaled by sqrt(2 / fan_in), with no truncation-variance correction
    (``deepcalcium_tpu.models.blocks._truncated_normal``)."""
    return _truncated_normal_(w, (2.0 / fan_in) ** 0.5, generator)


INIT_SCHEMES = ("he_normal", "he_uniform", "glorot_uniform", "glorot_normal")


def _truncated_normal_(w, stddev: float, generator):
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(stddev)
    return w


def kernel_init_(w: torch.Tensor, fan_in: int, fan_out: int,
                 scheme: str = "he_normal", generator=None):
    """Fill ``w`` by scheme name, the init axis of the hyperparameter search
    (``deepcalcium_tpu.models.blocks.kernel_init``). The normal schemes are the
    Keras-2.0.6 +-2 sigma truncated normal with no variance correction, of
    sigma sqrt(2 / fan_in) (``he_normal``) or sqrt(2 / (fan_in + fan_out))
    (``glorot_normal``); the uniform schemes draw in [-lim, lim] with lim
    sqrt(6 / fan_in) (``he_uniform``) or sqrt(6 / (fan_in + fan_out))
    (``glorot_uniform``). ``he_normal`` consumes ``generator`` exactly as
    :func:`he_normal_` does."""
    if scheme not in INIT_SCHEMES:
        raise ValueError(f"unknown init scheme: {scheme!r}")
    fan = fan_in if scheme.startswith("he") else fan_in + fan_out
    if scheme.endswith("normal"):
        return _truncated_normal_(w, (2.0 / fan) ** 0.5, generator)
    lim = (6.0 / fan) ** 0.5
    with torch.no_grad():
        return w.uniform_(-lim, lim, generator=generator)


def _cast(dtype, *ts):
    return ts if dtype is None else tuple(t.to(dtype) for t in ts)


def conv2d(x, weight, bias, dtype=None):
    """SAME stride-1 conv: (B, Cin, H, W) x OIHW (odd k) -> (B, Cout, H, W).
    The bias is added after the conv, in the compute dtype, as
    ``conv_general_dilated(...) + b`` does in the JAX package."""
    x, weight, bias = _cast(dtype, x, weight, bias)
    y = F.conv2d(x, weight, None, padding=weight.shape[-1] // 2)
    return y + bias[:, None, None]


def conv1d(x, weight, bias, dtype=None):
    """SAME stride-1 conv: (B, Cin, T) x OIW (odd k) -> (B, Cout, T), the
    bias added after the conv in the compute dtype (``blocks.conv1d``). The
    JAX package's WIO kernel is OIW permuted by (2, 1, 0)."""
    x, weight, bias = _cast(dtype, x, weight, bias)
    y = F.conv1d(x, weight, None, padding=weight.shape[-1] // 2)
    return y + bias[:, None]


def tconv2x2(x, weight, bias, dtype=None):
    """Conv2DTranspose(k=2, s=2, VALID) with a (Cin, Cout, 2, 2) kernel:
    out[b, o, 2i+p, 2j+q] = sum_c x[b, c, i, j] * weight[c, o, p, q] + bias[o]."""
    x, weight, bias = _cast(dtype, x, weight, bias)
    y = F.conv_transpose2d(x, weight, None, stride=2)
    return y + bias[:, None, None]


def maxpool2(x):
    """MaxPooling2D(2, strides=2). The gradient goes to the first maximum
    of each 2x2 window in row-major order, as the JAX package's dense
    ``custom_vjp`` routes it: PyTorch's CPU and CUDA max-pool kernels keep
    the first of tied maxima. ``tests/test_torch_train.py`` pins this
    against the JAX vjp and ``chip_smoke.py`` on the card."""
    return F.max_pool2d(x, 2)


def pool2(x):
    """MaxPooling1D(2, strides=2) on (B, C, T). The gradient of a window
    goes to its first element when ``a >= b``, as the JAX package's dense
    ``pool2_axis`` vjp routes it: PyTorch's CPU and CUDA max-pool kernels
    keep the first of tied maxima (``torch.maximum`` would split a tied
    gradient in half). ``tests/test_torch_unet1d.py`` pins this against the
    JAX vjp and ``chip_smoke.py`` on the card."""
    return F.max_pool1d(x, 2)


def maxpool1d_same(x, window: int):
    """MaxPooling1D(window, strides=1, padding="SAME") on (B, C, T), the
    1-D net's margin head (``blocks.maxpool1d``). XLA's SAME pads
    ``(window - 1) // 2`` low and the rest high, unevenly for an even
    window, which ``F.max_pool1d`` cannot: the -inf padding is explicit.
    Each output's gradient goes to the first maximum of its window, as the
    transpose of XLA's ``reduce_window`` (``select_and_scatter`` with
    ``>=``) routes it."""
    if window <= 1:
        return x
    lo = (window - 1) // 2
    xp = F.pad(x, (lo, window - 1 - lo), value=float("-inf"))
    return F.max_pool1d(xp, window, stride=1)


def upsample1d(x):
    """UpSampling1D(2) on (B, C, T): each sample repeated twice."""
    return x.repeat_interleave(2, dim=2)


def _per_channel(v, x):
    """A (C,) vector shaped to broadcast over channels-first ``x``."""
    return v.view((1, -1) + (1,) * (x.dim() - 2))


def batch_norm(x, gamma, beta, mean, var):
    """Eval-mode Keras BN over channels (dim 1) of a tensor of any rank.
    The scale is formed in float32 and cast to ``x.dtype`` with the
    statistics, as in the JAX package's ``batch_norm(train=False)``."""
    inv = torch.rsqrt(var + BN_EPS) * gamma
    dt = x.dtype
    return ((x - _per_channel(mean.to(dt), x)) * _per_channel(inv.to(dt), x)
            + _per_channel(beta.to(dt), x))


def batch_stats(x, mesh=None):
    """Batch mean and biased variance per channel (dim 1) over every other
    dim, in float32 whatever ``x.dtype`` is
    (``blocks.batch_norm(train=True)``). Differentiable: the train-mode
    gradient flows through both.

    With a ``mesh`` (``parallel.mesh.Mesh``) ``x`` is this rank's shard and
    the statistics are those of the global batch, as GSPMD computes them in
    the JAX package. The ranks' shards are equally large, so the global
    mean is the mean of the ranks' means, and the global variance the mean
    of the ranks' ``var + (mean - global mean)**2`` (Chan's combination;
    ``E[x**2] - mean**2`` would cancel in float32). Both all-reduces are
    differentiable, so the gradient is the global batch's too. On a mesh of
    one rank the result has the bits of the plain one."""
    dims = (0,) + tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
    if mesh is None:
        return mean, var
    gmean = psum(mean, mesh) / mesh.size
    gvar = psum(var + (mean - gmean) ** 2, mesh) / mesh.size
    return gmean, gvar


def dropout_with_mask(x, rate: float, mask):
    """Inverted dropout from a boolean keep-mask: ``x / keep`` where the mask
    is set, 0 elsewhere, in ``x.dtype``."""
    if mask is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def dropout(x, rate: float, train: bool, generator=None):
    """Inverted dropout (Keras semantics), train-only. The keep-mask is
    drawn from ``generator``, which must live on ``x.device``; the JAX
    package's threefry stream cannot be reproduced, so tests inject masks
    through :func:`dropout_with_mask`."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return dropout_with_mask(x, rate, mask)


class Conv2d(nn.Module):
    """SAME conv holder: ``weight`` OIHW, ``bias`` (Cout,). Fans are
    k * k * Cin and k * k * Cout (``blocks.init_conv``)."""

    def __init__(self, cin, cout, k, generator, init_scheme="he_normal"):
        super().__init__()
        self.weight = nn.Parameter(kernel_init_(
            torch.empty(cout, cin, k, k), k * k * cin, k * k * cout,
            init_scheme, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, dtype=None):
        return conv2d(x, self.weight, self.bias, dtype)


class Conv1d(nn.Module):
    """SAME 1-D conv holder: ``weight`` OIW, ``bias`` (Cout,); he_normal
    with fan_in k * Cin (``blocks.init_conv1d``)."""

    def __init__(self, cin, cout, k, generator):
        super().__init__()
        self.weight = nn.Parameter(he_normal_(torch.empty(cout, cin, k),
                                              cin * k, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, dtype=None):
        return conv1d(x, self.weight, self.bias, dtype)


class ConvTranspose2x2(nn.Module):
    """k=s=2 transpose conv holder: ``weight`` (Cin, Cout, 2, 2).

    fan_in is 4 * Cout and fan_out 4 * Cin, the Keras quirk the JAX package
    keeps (``blocks.init_tconv``: Keras reads fans off the raw HWOI shape)."""

    def __init__(self, cin, cout, generator, init_scheme="he_normal"):
        super().__init__()
        self.weight = nn.Parameter(kernel_init_(
            torch.empty(cin, cout, 2, 2), 4 * cout, 4 * cin, init_scheme,
            generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, dtype=None):
        return tconv2x2(x, self.weight, self.bias, dtype)


class BatchNorm(nn.Module):
    """Keras BN: ``weight``/``bias`` are gamma/beta, the buffers
    ``running_mean``/``running_var`` its moving statistics, and
    ``momentum`` the Keras one (0.99 after convs, 0.5 after transpose
    convs): ``running = momentum * running + (1 - momentum) * batch``."""

    def __init__(self, c, momentum: float = 0.99):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool = False, mesh=None):
        """Eval mode normalises by the running statistics. Train mode
        normalises by the batch statistics (the global batch's under a
        ``mesh``) and updates the running ones in place."""
        if not train:
            return batch_norm(x, self.weight, self.bias, self.running_mean,
                              self.running_var)
        mean, var = batch_stats(x, mesh)
        self.update_running(mean, var)
        return batch_norm(x, self.weight, self.bias, mean, var)

    @torch.no_grad()
    def update_running(self, mean, var):
        """Fold batch statistics into the running ones, with the biased
        variance."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

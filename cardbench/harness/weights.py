"""Weights of a cell, made on the card from the seed in a few large calls,
and handed in the checkpoint format's layout ((params, state) trees of
float32 numpy arrays, HWIO / WIO kernels) to the measured package and, as
PyTorch tensors, to the reference.

Kernels are he-normal (sigma sqrt(2 / fan_in), clipped at 2 sigma), biases
N(0, 0.05), BN gamma 1 + N(0, 0.1) and beta N(0, 0.1). The BN statistics
are those of a calibration batch that the reference's training-mode
forward normalises layer by layer, so that every layer sees normalised
inputs in eval mode, as in a trained net, and the outputs are neither
saturated nor constant."""

import numpy as np
import torch

from cardbench.reference import unet1d, unet2ds
from cardbench.reference.precision import exact_fp32


def _ref(config):
    return unet2ds if config["arch"] == "unet2ds" else unet1d


def _kernel_shape(arch, kind, ci, co):
    """(JAX layout shape, fan_in) of a kernel."""
    if kind == "conv3":
        return (3, 3, ci, co), 9 * ci
    if kind == "tconv":
        return (2, 2, co, ci), ci
    if kind == "conv5":
        return (5, ci, co), 5 * ci
    return ((1, 1, ci, co) if arch == "unet2ds" else (1, ci, co)), ci


def make(config, seed, device, calib):
    """(params, state, W): the trees for the measured package and the
    reference's weight dict (with the BN statistics) on ``device``.
    ``calib`` is the calibration batch, (B, H, W) or (B, T) on ``device``."""
    ref = _ref(config)
    layers = ref.layers(config["nfb"])
    leaves = []
    for name, kind, ci, co in layers:
        if kind == "bn":
            leaves += [(name, "gamma", (co,), 0.1, 1.0),
                       (name, "beta", (co,), 0.1, 0.0)]
        else:
            shape, fan = _kernel_shape(config["arch"], kind, ci, co)
            leaves += [(name, "kernel", shape, (2.0 / fan) ** 0.5, 0.0),
                       (name, "bias", (co,), 0.05, 0.0)]
    total = sum(int(np.prod(s)) for _, _, s, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    params, i = {}, 0
    for name, leaf, shape, std, mean in leaves:
        n = int(np.prod(shape))
        params.setdefault(name, {})[leaf] = z[i:i + n].view(shape) * std + mean
        i += n
    host = {k: {l: v.cpu().numpy() for l, v in d.items()}
            for k, d in params.items()}
    state = {name: {"mean": np.zeros(co, np.float32),
                    "var": np.ones(co, np.float32)}
             for name, kind, _, co in layers if kind == "bn"}
    W = ref.from_jax_layout(host, state, device)
    stats = {}
    with torch.no_grad(), exact_fp32():
        ref.forward(W, calib, train=True, stats=stats)
    for name, (m, v) in stats.items():
        state[name] = {"mean": m.cpu().numpy(), "var": v.cpu().numpy()}
        W[f"{name}.mean"], W[f"{name}.var"] = m, v
    return host, state, W

"""Import Keras 2.x HDF5 checkpoints of UNet2DS and UNet1D.

Port of ``deepcalcium_tpu.interop.keras_import`` (``read_keras_weight_groups``,
``_assign``, ``load_unet2ds_keras``, ``load_unet1d_keras``): the reference
ships its released weights as Keras ``save_model`` HDF5 files
(``unet2ds_model.hdf5``, ``unet1d_model.hdf5``). The result is (params,
state) in the JAX package's layout, as numpy arrays, so that
``models.unet2d.from_jax_params`` or ``models.unet1d.from_jax_params``
builds the net from it.

Keras 2.0.x HDF5 layout:

    /model_weights  attrs: layer_names = [b"input_1", b"conv2d_1", ...]
    /model_weights/<layer>/ attrs: weight_names = [b"conv2d_1/kernel:0", ...]
    /model_weights/<layer>/<weight path> -> dataset

Keras Conv2D kernels (kh, kw, in, out), Conv1D kernels (k, in, out) and
Conv2DTranspose kernels (kh, kw, out, in) are the JAX package's HWIO, WIO
and HWOI; BatchNorm's
[gamma, beta, moving_mean, moving_variance] become params {gamma, beta} and
state {mean, var}. ``layer_names`` keeps the functional model's build
order, which is the order of ``unet2d.layer_order`` and
``unet1d.layer_order``; weightless layers are skipped. ``h5py`` is imported only when a file is read.
"""

import logging

import numpy as np

from deepcalcium_torch.models import unet1d, unet2d

__all__ = ["read_keras_weight_groups", "load_unet2ds_keras",
           "load_unet1d_keras"]

logger = logging.getLogger(__name__)


def read_keras_weight_groups(h5path: str):
    """[(layer_name, [numpy arrays])] of the weight-bearing layers, in
    build order."""
    import h5py

    out = []
    with h5py.File(h5path, "r") as fp:
        g = fp["model_weights"] if "model_weights" in fp else fp
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in g.attrs["layer_names"]]
        for lname in layer_names:
            lg = g[lname]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in lg.attrs.get("weight_names", [])]
            if not wnames:
                continue
            out.append((lname, [np.asarray(lg[w]) for w in wnames]))
    return out


def _assign(layer_table, groups, expect_kinds):
    """Map Keras weight groups onto (params, state) by walking both orders
    in lockstep; a layer of the wrong kind, kernel size or width raises."""
    params, state = {}, {}
    spatial = {"conv3": (3, 3), "conv5": (5, 5), "conv1": (1, 1),
               "tconv": (2, 2)}
    gi = iter(groups)
    for name, kind, cout in layer_table:
        try:
            lname, ws = next(gi)
        except StopIteration:
            raise ValueError(
                f"Keras checkpoint ran out of weight-bearing layers at "
                f"{name} ({kind}): wrong or truncated architecture") from None
        if kind in ("conv3", "conv5", "conv1"):
            if not lname.startswith(expect_kinds["conv"]) or \
                    lname.startswith("conv2d_transpose"):
                raise ValueError(f"expected a conv at {name}, got {lname}")
            kernel, bias = ws
            want = spatial[kind][: kernel.ndim - 2]
            if (kernel.ndim not in (3, 4)
                    or kernel.shape[: kernel.ndim - 2] != want
                    or kernel.shape[-1] != cout):
                raise ValueError(
                    f"{name}: expected a {spatial[kind]} conv with "
                    f"{cout} out-ch, got kernel {kernel.shape}")
            params[name] = {"kernel": np.asarray(kernel, np.float32),
                            "bias": np.asarray(bias, np.float32)}
        elif kind == "tconv":
            if not lname.startswith("conv2d_transpose"):
                raise ValueError(f"expected conv2d_transpose at {name}, "
                                 f"got {lname}")
            kernel, bias = ws
            if kernel.ndim != 4 or kernel.shape[:3] != (2, 2, cout):
                raise ValueError(
                    f"{name}: expected (2, 2, {cout}, in) tconv, got "
                    f"kernel {kernel.shape}")
            params[name] = {"kernel": np.asarray(kernel, np.float32),
                            "bias": np.asarray(bias, np.float32)}
        elif kind == "bn":
            if not lname.startswith("batch_normalization"):
                raise ValueError(f"expected batch_normalization at {name}, "
                                 f"got {lname}")
            gamma, beta, mean, var = ws
            params[name] = {"gamma": np.asarray(gamma, np.float32),
                            "beta": np.asarray(beta, np.float32)}
            state[name] = {"mean": np.asarray(mean, np.float32),
                           "var": np.asarray(var, np.float32)}
        else:
            raise ValueError(f"unknown layer kind {kind}")
    remaining = list(gi)
    if remaining:
        raise ValueError(f"unconsumed Keras layers: {[n for n, _ in remaining]}")
    return params, state


def load_unet2ds_keras(h5path: str, nfb: int | None = None):
    """Keras ``unet2ds_model.hdf5`` -> (params, state) of numpy arrays in
    the JAX package's layout.

    ``nfb`` (base filters) and the up-path mode are read off the file when
    not given: nfb is the first conv's output width; any conv2d_transpose
    group selects the transpose mode.
    """
    groups = read_keras_weight_groups(h5path)
    if nfb is None:
        nfb = int(groups[0][1][0].shape[-1])
    up_mode = ("transpose" if any(n.startswith("conv2d_transpose")
                                  for n, _ in groups) else "upsampling")
    params, state = _assign(unet2d.layer_order(nfb, up_mode), groups,
                            {"conv": "conv2d"})
    logger.info("Imported %d Keras layers from %s (nfb=%d, up=%s)",
                len(groups), h5path, nfb, up_mode)
    return params, state


def load_unet1d_keras(h5path: str, nfb: int | None = None):
    """Keras ``unet1d_model.hdf5`` -> (params, state) of numpy arrays in
    the JAX package's layout; ``nfb`` is the first conv's output width when
    not given."""
    groups = read_keras_weight_groups(h5path)
    if nfb is None:
        nfb = int(groups[0][1][0].shape[-1])
    params, state = _assign(unet1d.layer_order(nfb), groups,
                            {"conv": "conv1d"})
    logger.info("Imported %d Keras layers from %s (nfb=%d)",
                len(groups), h5path, nfb)
    return params, state

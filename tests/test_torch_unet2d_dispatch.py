"""Which net ``UNet2DSummary.evaluate_movie`` and ``predict`` run, against
the JAX package's ``_resolve_apply_fn``, on the CPU with the golden tiny
net (``tests/golden/unet2d_tiny.ckpt``, nfb=4), ``data/fixtures.py``
datasets and a 48x48 window.

The net is ``net_func``'s, as ``fit`` trains it: the stock ``UNet2DS`` (or
a ``functools.partial`` of it) is built off the weights, any other
``net_func`` is called and loaded. ``fast=True`` folds whatever net that is; "auto"
folds only a ``UNet2DS`` itself, with a transpose-mode checkpoint and a
window of multiples of 16, as the JAX package takes its fast path only for
``net_apply_func is unet2d.apply``.

Tolerances: a custom net's probabilities are the stock net's at rtol 1e-6,
atol 1e-7 (the same forward on the same weights), and the JAX custom
``net_apply_func``'s at rtol 1e-4, atol 1e-5, as
``tests/test_torch_predict.py`` holds the stock wrapper; masks are equal
(the golden net's probabilities lie far from 0.5 on these inputs).
"""

import functools
import logging
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import make_neurons_hdf5
from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.models import unet_2d_summary as jsummary
from deepcalcium_tpu.models.unet2d_fast import apply_fast_w
from deepcalcium_torch.models import unet_2d_summary as tsummary
from deepcalcium_torch.models.unet2d import UNet2DS
from deepcalcium_torch.train.checkpoints import load_checkpoint

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CKPT = os.path.join(GOLD, "unet2d_tiny.ckpt")
WINDOW = (48, 48)
FOLD_LOG = "running the folded inference forward"


class _CountingUNet2DS(UNet2DS):
    """A custom net: a ``UNet2DS`` subclass that counts its forwards."""

    calls = 0

    def forward(self, x, *a, **kw):
        type(self).calls += 1
        return super().forward(x, *a, **kw)


def _counting_apply(*a, **kw):
    """A custom JAX forward: ``unet2d.apply`` under another name, counting
    the calls (jit traces) that reach it."""
    _counting_apply.calls += 1
    return junet.apply(*a, **kw)


_counting_apply.calls = 0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An in-window (48x48) and an oversized (70x100, tiled) dataset."""
    d = tmp_path_factory.mktemp("dispatch")
    return {"dir": d, **{key: make_neurons_hdf5(
        str(d / key / "dataset.hdf5"), name=f"neurofinder.0{i}.00",
        shape=shape, nb_frames=11, nb_neurons=4, seed=i)
        for i, (key, shape) in enumerate([("fit", (48, 48)),
                                          ("big", (70, 100))])}}


def _port(files, **kw):
    return tsummary.UNet2DSummary(cpdir=str(files["dir"] / "t"), device="cpu",
                                  **kw)


def _raw(path):
    with h5py.File(path, "r") as fp:
        return fp["series/raw"][...]


def _infer(model, files, route, fast, datasets=("fit", "big")):
    """(masks, probs or None) of one inference route."""
    if route == "predict":
        masks, _ = model.predict([files[k] for k in datasets], CKPT,
                                 window_shape=WINDOW, augmentation=True,
                                 fast=fast)
        return masks, None
    params, state, _ = load_checkpoint(CKPT)
    movie = {"array": lambda: _raw(files["fit"]),
             "path": lambda: files["fit"],
             "tiled": lambda: _raw(files["big"])}[route]()
    mask, prob = model.evaluate_movie(movie, params=params, state=state,
                                      window_shape=WINDOW, fast=fast)
    return [mask], [prob]


@pytest.mark.parametrize("fast", ["auto", True])
@pytest.mark.parametrize("route", ["array", "path", "tiled", "predict"])
def test_inference_builds_through_net_func(files, route, fast, caplog):
    """A custom ``net_func`` runs in every 2-D inference route: unfolded
    under "auto", folded at ``fast=True``; its results are the stock
    net's at the same fold."""
    _CountingUNet2DS.calls = 0
    model = _port(files, net_func=functools.partial(_CountingUNet2DS, nfb=4))
    with caplog.at_level(logging.INFO, logger=tsummary.__name__):
        masks, probs = _infer(model, files, route, fast)
    assert _CountingUNet2DS.calls > 0
    assert (FOLD_LOG in caplog.text) == (fast is True)
    want_masks, want_probs = _infer(_port(files), files, route, fast is True)
    assert any(m.any() for m in masks), "an all-empty mask tests nothing"
    for a, b in zip(masks, want_masks):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    for a, b in zip(probs or (), want_probs or ()):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("route", ["path", "tiled", "predict"])
def test_custom_net_matches_jax_custom_apply(files, route):
    """Under "auto" the port's custom net and the JAX package's custom
    ``net_apply_func`` both run, neither folded nor W-packed, and give the
    same result."""
    _CountingUNet2DS.calls = _counting_apply.calls = 0
    model = _port(files, net_func=functools.partial(_CountingUNet2DS, nfb=4))
    jmodel = jsummary.UNet2DSummary(
        cpdir=str(files["dir"] / "j"),
        net_init_func=functools.partial(junet.init, nfb=4),
        net_apply_func=_counting_apply)
    if route == "tiled":
        # A path whose frames exceed the window: both packages tile.
        route, files = "path", dict(files, fit=files["big"])
    # predict of the in-window dataset alone: the tiled forward is the
    # route above, and each JAX predict route costs its own compiles.
    masks, probs = _infer(model, files, route, "auto", ("fit",))
    jmasks, jprobs = _infer(jmodel, files, route, "auto", ("fit",))
    assert _CountingUNet2DS.calls > 0 and _counting_apply.calls > 0
    for a, b in zip(masks, jmasks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(probs or (), jprobs or ()):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def weights():
    """(params, state) of both up modes: the golden transpose-mode net and
    an upsampling-mode one from the JAX package's ``init``."""
    up = junet.init(jax.random.PRNGKey(0), nfb=4, up_mode="upsampling")
    up = jax.tree.map(lambda v: np.asarray(v, np.float32), up)
    return {"transpose": load_checkpoint(CKPT)[:2], "upsampling": up}


@pytest.mark.parametrize("fast", ["auto", True, False])
@pytest.mark.parametrize("kind", ["stock", "partial", "subclass"])
def test_fold_dispatch_matches_jax(weights, tmp_path, kind, fast):
    """The port folds exactly when the JAX package's ``_resolve_apply_fn``
    takes its fast path, over both up modes and a window of multiples of
    16 or not; nothing runs. One case parts on purpose: a partial of the
    stock class is stock in the port, so "auto" folds it, where JAX's
    ``functools.partial(unet2d.apply, ...)`` fails ``is unet2d.apply`` and
    runs the plain forward (the same function up to float rounding)."""
    for mode, (params, state) in weights.items():
        net_func, apply_fn = {
            "stock": (UNet2DS, junet.apply),
            "partial": (functools.partial(UNet2DS, nfb=4, up_mode=mode,
                                          drp=0.0),
                        functools.partial(junet.apply, drp=0.0)),
            "subclass": (functools.partial(_CountingUNet2DS, nfb=4,
                                           up_mode=mode), _counting_apply),
        }[kind]
        port = tsummary.UNet2DSummary(cpdir=str(tmp_path / "t"), device="cpu",
                                      net_func=net_func)
        jmodel = jsummary.UNet2DSummary(cpdir=str(tmp_path / "j"),
                                        net_apply_func=apply_fn)
        for window in ((48, 48), (50, 50)):
            net = port._inference_net(params, state, window, fast)
            jfast = jmodel._resolve_apply_fn(fast, params, (window,)).func \
                is apply_fast_w
            assert isinstance(net, _CountingUNet2DS) == (kind == "subclass")
            assert not net.training and net.up_mode == mode
            pinned = (kind == "partial" and fast == "auto"
                      and mode == "transpose" and window == (48, 48))
            assert net.folded == (jfast or pinned), (mode, window)
            assert not (pinned and jfast)

"""``UNet2DSummary.predict``, ``evaluate_movie`` from an HDF5 path or with
oversized frames, and ``nf_submit`` of the port against the JAX package's,
on the CPU, with the golden tiny net (``tests/golden/unet2d_tiny.ckpt``,
nfb=4) on ``data/fixtures.py`` datasets and a 48x48 window.

Tolerances: the thresholded masks must be equal (the golden net's
probabilities lie far from 0.5 on these inputs, so float rounding of the
two forwards cannot flip a pixel); ``evaluate_movie``'s prob at rtol 1e-4,
atol 1e-5, as ``tests/test_evaluate_movie.py``; submission JSON equal.
"""

import functools
import json
import logging
import os

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from deepcalcium_tpu.data import nf as jnf
from deepcalcium_tpu.data.fixtures import make_neurons_hdf5
from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.models import unet_2d_summary as jsummary
from deepcalcium_torch.data import nf as tnf
from deepcalcium_torch.models import unet_2d_summary as tsummary
from deepcalcium_torch.train.checkpoints import load_checkpoint

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CKPT = os.path.join(GOLD, "unet2d_tiny.ckpt")
WINDOW = (48, 48)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """In-window (48x48, and 40x44 which reflect-pads) and oversized
    (96x96, tiled) datasets."""
    d = tmp_path_factory.mktemp("nf")
    return [make_neurons_hdf5(str(d / f"ds{i}" / "dataset.hdf5"),
                              name=f"neurofinder.0{i}.00", shape=shape,
                              nb_frames=12, nb_neurons=4, seed=i)
            for i, shape in enumerate([(48, 48), (40, 44), (96, 96)])]


def _jax_model(cpdir):
    return jsummary.UNet2DSummary(
        cpdir=str(cpdir), net_init_func=functools.partial(junet.init, nfb=4))


def _port_model(cpdir):
    return tsummary.UNet2DSummary(cpdir=str(cpdir), device="cpu")


@pytest.mark.parametrize("augmentation", [True, False])
def test_predict_matches_jax(datasets, tmp_path, augmentation):
    jmp, jnames = _jax_model(tmp_path / "j").predict(
        datasets, CKPT, window_shape=WINDOW, augmentation=augmentation,
        fast=False, max_batch=4)
    mp, names = _port_model(tmp_path / "t").predict(
        datasets, CKPT, window_shape=WINDOW, augmentation=augmentation,
        max_batch=4)
    assert names == jnames
    for a, b in zip(mp, jmp):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert any(m.any() for m in mp), "an all-empty prediction tests nothing"


def test_predict_scores_and_saves(datasets, tmp_path, caplog):
    """print_scores logs each dataset's scores and their means; save writes
    the same outlined PNG as the JAX package, and a views/s line is
    logged."""
    jmodel = _jax_model(tmp_path / "j")
    jmodel.predict(datasets, CKPT, window_shape=WINDOW, augmentation=True,
                   fast=False, save=True)
    model = _port_model(tmp_path / "t")
    with caplog.at_level(logging.INFO):
        mp, names = model.predict(datasets, CKPT, window_shape=WINDOW,
                                  augmentation=True, print_scores=True,
                                  save=True)
    text = caplog.text
    for name in names:
        assert f"{name}: prec=" in text
    assert "Mean prec=" in text
    assert "predict_forward:" in text and "views/s" in text
    for name in names:
        got = np.asarray(Image.open(tmp_path / "t" / f"{name}_mp.png"))
        want = np.asarray(Image.open(tmp_path / "j" / f"{name}_mp.png"))
        np.testing.assert_array_equal(got, want)


def test_predict_with_injection_points(tmp_path):
    """predict from summaries in memory, as on a machine without h5py."""
    rng = np.random.default_rng(0)
    S = {"a": rng.standard_normal((48, 48)).astype(np.float32),
         "b": rng.standard_normal((70, 50)).astype(np.float32)}
    model = tsummary.UNet2DSummary(
        cpdir=str(tmp_path), device="cpu", dataset_name_func=lambda n: n,
        series_summary_func=lambda n: S[n])
    mp, names = model.predict(list(S), CKPT, window_shape=WINDOW,
                              augmentation=True)
    assert names == ["a", "b"]
    assert [m.shape for m in mp] == [(48, 48), (70, 50)]
    with pytest.raises(TypeError, match="Mesh"):
        model.predict(list(S), CKPT, window_shape=WINDOW, mesh=object())


@pytest.mark.parametrize("shape", [(48, 48), (70, 100)])
def test_evaluate_movie_from_hdf5_path_matches_jax(tmp_path, shape):
    """A path streams (48x48) or runs tiled (70x100), as in JAX."""
    ds = make_neurons_hdf5(str(tmp_path / "d" / "dataset.hdf5"),
                           name="ev.0", shape=shape, nb_frames=11)
    params, state, _ = load_checkpoint(CKPT)
    kw = dict(params=params, state=state, window_shape=WINDOW)
    jmask, jprob = _jax_model(tmp_path / "j").evaluate_movie(ds, fast=False, **kw)
    mask, prob = _port_model(tmp_path / "t").evaluate_movie(ds, **kw)
    np.testing.assert_allclose(prob, jprob, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(mask, jmask)
    # The same movie as an array: the oversized one runs tiled too.
    with h5py.File(ds, "r") as fp:
        movie = fp["series/raw"][...]
    amask, aprob = _port_model(tmp_path / "t").evaluate_movie(movie, **kw)
    np.testing.assert_array_equal(amask, mask)
    np.testing.assert_allclose(aprob, prob, rtol=1e-6, atol=1e-7)


def test_nf_submit_matches_jax(datasets, tmp_path):
    mp, names = _port_model(tmp_path / "t").predict(
        datasets, CKPT, window_shape=WINDOW, augmentation=True)
    mp = mp + [np.zeros((10, 12), np.uint8)]
    names = names + ["neurofinder.09.00.test"]
    tnf.nf_submit(mp, names, str(tmp_path / "t.json"))
    jnf.nf_submit(mp, names, str(tmp_path / "j.json"))
    with open(tmp_path / "t.json") as a, open(tmp_path / "j.json") as b:
        got, want = a.read(), b.read()
    assert got == want
    sub = json.loads(got)
    assert [s["dataset"] for s in sub] == ["00.00", "01.00", "02.00", "09.00.test"]
    assert sub[-1]["regions"] == [{"coordinates": [[0, 0]]}]
    assert len(sub[0]["regions"]) == tnf.label_mask(mp[0]).max()

"""The port's Keras HDF5 import against the JAX package's, on the CPU, on
``data/fixtures.make_keras_unet2ds_hdf5`` files at nfb=4: the same arrays,
the same three rejections as ``tests/test_keras_import.py``, predict from
the Keras file, and ``fit``'s warm start from it. Arrays must be equal;
predicted masks too (the same weights, and probabilities away from 0.5)."""

import functools

import h5py
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import make_keras_unet2ds_hdf5, make_neurons_hdf5
from deepcalcium_tpu.interop import keras_import as jki
from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.models import unet_2d_summary as jsummary
from deepcalcium_torch.interop import keras_import as tki
from deepcalcium_torch.models import unet_2d_summary as tsummary
from deepcalcium_torch.models.unet2d import UNet2DS
from deepcalcium_torch.train.checkpoints import read_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def keras_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras")
    return make_keras_unet2ds_hdf5(str(d / "unet2ds_model.hdf5"), nfb=4, seed=1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    return make_neurons_hdf5(str(d / "dataset.hdf5"), name="mig.0",
                             shape=(96, 96), nb_frames=16)


@pytest.mark.parametrize("nfb", [None, 4])
def test_import_matches_jax(keras_file, nfb):
    params, state = tki.load_unet2ds_keras(keras_file, nfb=nfb)
    jparams, jstate = jki.load_unet2ds_keras(keras_file, nfb=nfb)
    for tree, jtree in ((params, jparams), (state, jstate)):
        assert sorted(tree) == sorted(jtree)
        for layer in jtree:
            assert sorted(tree[layer]) == sorted(jtree[layer])
            for leaf in jtree[layer]:
                a, b = tree[layer][leaf], np.asarray(jtree[layer][leaf])
                assert a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    groups = tki.read_keras_weight_groups(keras_file)
    jgroups = jki.read_keras_weight_groups(keras_file)
    assert [n for n, _ in groups] == [n for n, _ in jgroups]


def _swap_first_conv_and_bn(path):
    with h5py.File(path, "a") as fp:
        names = list(fp["model_weights"].attrs["layer_names"])
        i, j = names.index(b"conv2d_1"), names.index(b"batch_normalization_1")
        names[i], names[j] = names[j], names[i]
        fp["model_weights"].attrs["layer_names"] = np.array(names)


def _widen_first_kernel_to_5x5(path):
    with h5py.File(path, "a") as fp:
        g = fp["model_weights/conv2d_1"]
        kname = [n.decode() for n in g.attrs["weight_names"] if b"kernel" in n][0]
        k = np.asarray(g[kname])
        del g[kname]
        g.create_dataset(kname, data=np.zeros((5, 5) + k.shape[2:], k.dtype))


def _truncate(path):
    with h5py.File(path, "a") as fp:
        names = list(fp["model_weights"].attrs["layer_names"])
        fp["model_weights"].attrs["layer_names"] = np.array(names[:-4])


@pytest.mark.parametrize("corrupt,match", [
    (_swap_first_conv_and_bn, "expected"),
    (_widen_first_kernel_to_5x5, "conv"),
    (_truncate, "ran out"),
], ids=["wrong_order", "wrong_kernel_size", "truncated"])
def test_import_rejects_what_jax_rejects(tmp_path, corrupt, match):
    path = make_keras_unet2ds_hdf5(str(tmp_path / "bad.hdf5"), nfb=4)
    corrupt(path)
    with pytest.raises(ValueError, match=match):
        jki.load_unet2ds_keras(path, nfb=4)
    with pytest.raises(ValueError, match=match):
        tki.load_unet2ds_keras(path, nfb=4)


@pytest.mark.parametrize("augmentation", [True, False])
def test_predict_from_keras_file_matches_jax(keras_file, dataset, tmp_path,
                                              augmentation):
    jmodel = jsummary.UNet2DSummary(
        cpdir=str(tmp_path / "j"), net_init_func=functools.partial(junet.init, nfb=4))
    jmp, jnames = jmodel.predict([dataset], keras_file, window_shape=(96, 96),
                                 augmentation=augmentation, fast=False)
    model = tsummary.UNet2DSummary(cpdir=str(tmp_path / "t"), device="cpu")
    mp, names = model.predict([dataset], keras_file, window_shape=(96, 96),
                              augmentation=augmentation)
    assert names == jnames == ["mig.0"]
    np.testing.assert_array_equal(mp[0], jmp[0])


@pytest.mark.parametrize("proceed", [True, False])
def test_fit_warm_starts_from_keras_file(keras_file, dataset, tmp_path, proceed):
    """At lr 0 Adam moves nothing, so the epoch-0 checkpoint holds the
    Keras weights bit for bit, as in JAX; a Keras file carries no Adam
    state, so the step count starts at 0 either way."""
    model = tsummary.UNet2DSummary(
        cpdir=str(tmp_path / "cp"), device="cpu",
        net_func=functools.partial(UNet2DS, nfb=4, drp=0.0))
    history, best = model.fit(
        [dataset], model_path=keras_file, proceed=proceed, learning_rate=0.0,
        shape_trn=(32, 32), shape_val=(96, 96), batch_size_trn=2,
        nb_steps_trn=1, nb_epochs=1)
    assert best is not None and np.isfinite(history["loss"][0])
    kparams, _ = tki.load_unet2ds_keras(keras_file)
    ckpt = read_checkpoint(best)
    for layer in kparams:
        for leaf in kparams[layer]:
            np.testing.assert_array_equal(ckpt["params"][layer][leaf],
                                          kparams[layer][leaf])
    assert int(ckpt["opt_state"]["count"]) == 1  # Adam started fresh

"""The port's spike wrapper against the JAX package's, on the CPU:
``UNet1DSegmentation.fit`` (random split and cross-validation) and
``predict`` on ``data/fixtures.make_spikes_hdf5`` datasets, checkpoints
read across both packages, ``load_unet1d_keras``, the knob checks, the
dataset accessors and label helpers, the sample plot and the C2S shim.

Both packages fit from the same initial weights (the tiny golden UNet1D,
nfb=4, with head biases 0.1 and -0.1 so that no probability sits at
exactly 0.5) at drp=0, float32, lr 1e-4, on the same numpy batches (the
batch generator is the same numpy code and seed). At Adam's eps 1e-8 the
conv biases that feed a BN walk by up to lr a step in a direction set by
rounding (``tests/test_torch_train.py``), so the trained nets differ by
about lr times the steps taken; the small lr keeps that far below the
tolerances:
- F2, prec, reca atol 5e-3 and ypspks atol 0.25: a few samples of the 1024
  a batch holds (8 windows of 128) crossing 0.5 (ypspks counts per row, so
  0.25 = two samples);
- ytspks (labels only) rtol 1e-6;
- predicted masks equal away from 2e-3 of the threshold.
"""

import functools
import logging
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import make_spikes_hdf5
from deepcalcium_tpu.interop import keras_import as jki
from deepcalcium_tpu.models import unet1d as junet
from deepcalcium_tpu.models import unet_1d_segmentation as jseg
from deepcalcium_tpu.train import checkpoints as jck
from deepcalcium_tpu.train import trainer as jtrainer
from deepcalcium_torch.interop import keras_import as tki
from deepcalcium_torch.models import unet_1d_segmentation as tseg
from deepcalcium_torch.models.c2s_segmentation import C2SSegmentation
from deepcalcium_torch.models.unet1d import UNet1D, from_jax_params, to_jax_params
from deepcalcium_torch.train import checkpoints as tck
from test_keras_import import _write_keras_h5

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIT = dict(shape=(128,), error_margin=4, batch=8, nb_epochs=2, seed=3,
           learning_rate=1e-4)
BAND = 2e-3  # masks may differ only this close to the threshold


def _init():
    raw = tck.read_checkpoint(os.path.join(GOLD, "unet1d_tiny.ckpt"))
    params = dict(raw["params"], head_conv={
        "kernel": raw["params"]["head_conv"]["kernel"],
        "bias": np.array([0.1, -0.1], np.float32)})
    return params, raw["state"]


def _jax_model(cpdir):
    params, state = _init()
    return jseg.UNet1DSegmentation(
        cpdir=str(cpdir),
        net_init_func=lambda key: jax.tree.map(np.array, (params, state)),
        net_apply_func=functools.partial(junet.apply, drp=0.0))


def _port_model(cpdir, **kw):
    kw.setdefault("init_params", _init())
    return tseg.UNet1DSegmentation(
        cpdir=str(cpdir), device="cpu",
        net_func=functools.partial(UNet1D, nfb=4, drp=0.0), **kw)


def _no_plots(monkeypatch):
    """Both packages' per-epoch plots as no-ops: matplotlib's text layout
    takes seconds a figure. ``test_fit_draws_its_own_init_from_the_seed``
    keeps them and checks the files."""
    import deepcalcium_tpu.utils.visualization as jvis
    import deepcalcium_torch.utils.visualization as tvis

    for mod, name in ((jseg, "plot_metrics_grid"), (tseg, "plot_metrics_grid"),
                      (jvis, "plot_traces_spikes"), (tvis, "plot_traces_spikes")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)


def _spy_splits(monkeypatch, cls):
    """Record the (train, validation) indices of every ``_fit_single``."""
    seen = []
    orig = cls._fit_single

    def spy(self, traces, spikes, idxs_trn, idxs_val, *a, **kw):
        seen.append((np.array(idxs_trn), np.array(idxs_val)))
        return orig(self, traces, spikes, idxs_trn, idxs_val, *a, **kw)

    monkeypatch.setattr(cls, "_fit_single", spy)
    return seen


def _assert_metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "ytspks":
            assert got[k] == pytest.approx(want[k], rel=1e-6), k
        elif k == "ypspks":
            assert abs(got[k] - want[k]) <= 0.25, (k, got[k], want[k])
        else:
            assert abs(got[k] - want[k]) <= 5e-3, (k, got[k], want[k])


def _probs(params, state, path):
    """The full-length probabilities of a dataset's traces (float32, the
    port's forward on the CPU: within 1e-6 of JAX's), for the band."""
    traces = jseg.get_dataset_traces(path).astype(np.float32)
    padded, t = jseg._pad_to_multiple(traces, 16)
    net = from_jax_params(params, state, margin=4).eval()
    with torch.no_grad():
        return net(torch.from_numpy(padded)).numpy()[:, :t]


def _assert_masks_close(got, want, probs):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    far = np.abs(probs - 0.5) >= BAND
    np.testing.assert_array_equal(got[far], want[far])


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = tmp_path_factory.mktemp("spikes")
    return [make_spikes_hdf5(str(d / f"sp{i}.hdf5"), name=f"spikes.{i}",
                             nb_traces=8, trace_len=256 - 40 * i, seed=i)
            for i in range(2)]


@pytest.fixture(scope="module")
def runs(datasets, tmp_path_factory):
    """random_split fits in both packages, with the split indices each
    used."""
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("fit")
    try:
        _no_plots(mp)
        jsplits = _spy_splits(mp, jseg.UNet1DSegmentation)
        tsplits = _spy_splits(mp, tseg.UNet1DSegmentation)
        jout = _jax_model(d / "jax").fit(datasets, **FIT)
        tout = _port_model(d / "port").fit(datasets, **FIT)
    finally:
        mp.undo()
    return {"jax": jout, "port": tout, "jsplits": jsplits,
            "tsplits": tsplits, "dir": d}


def test_random_split_fit_matches_jax(runs):
    (jmt, jmv, jbest), (tmt, tmv, tbest) = runs["jax"], runs["port"]
    for (jt, jv), (tt, tv) in zip(runs["jsplits"], runs["tsplits"]):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv, jv)
    _assert_metrics_close(tmt, jmt)
    _assert_metrics_close(tmv, jmv)
    tname, jname = (os.path.basename(p).split("_", 1)[1] for p in (tbest, jbest))
    assert tname == jname and tname.startswith("model_val_F2_")
    files = sorted(os.listdir(os.path.dirname(tbest)))
    assert [f.split("_", 1)[1] for f in files if f.endswith(".csv")] == ["metrics.csv"]
    with open(os.path.join(os.path.dirname(tbest), files[0])) as fp:
        header = fp.readline().strip().split(",")
    with open(os.path.join(os.path.dirname(jbest),
                           sorted(os.listdir(os.path.dirname(jbest)))[0])) as fp:
        assert header == fp.readline().strip().split(",")


def test_predict_matches_jax_across_checkpoints(runs, datasets):
    """Each package predicts from the other's best checkpoint and its own:
    names, shapes and dtypes equal, masks equal away from the threshold."""
    jmodel = _jax_model(runs["dir"] / "jp")
    tmodel = _port_model(runs["dir"] / "tp")
    for best in (runs["jax"][2], runs["port"][2]):
        jm, jn = jmodel.predict(datasets, best, batch=8, fast=False)
        tm, tn = tmodel.predict(datasets, best, batch=8, fast=False)
        assert tn == jn == ["spikes.0", "spikes.1"]
        params, state, _ = tck.load_checkpoint(best)
        for p, a, b in zip(datasets, tm, jm):
            _assert_masks_close(a, b, _probs(params, state, p))
        assert [m.shape for m in tm] == [(8, 256), (8, 216)]
    # The batch does not change the masks (no padded slab here).
    t32, _ = tmodel.predict(datasets, runs["port"][2], batch=32)
    t3, _ = tmodel.predict(datasets, runs["port"][2], batch=3)
    for a, b in zip(t32, t3):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_loads_in_jax_with_adam_state(runs):
    """The port's best checkpoint, with its Adam state, through the JAX
    package's reader with ``optimizer.init(params)`` as the template."""
    tbest = runs["port"][2]
    p0, s0 = _init()
    opt = jtrainer.make_optimizer(2e-3)
    params, state, opt_state, meta = jck.load_checkpoint(tbest, p0, s0,
                                                         opt.init(p0))
    # 12 of the 16 traces train at prop_trn 0.8: ceil(12 / 8) = 2 steps an
    # epoch.
    assert int(opt_state.count) == 2 * (meta["epoch"] + 1)
    assert jtrainer.current_lr(opt_state) == pytest.approx(1e-4, rel=1e-6)
    # The reloaded best net scores the fixed validation batch as it did.
    assert meta["val_F2"] == pytest.approx(runs["port"][1]["F2"], rel=1e-6)
    tp, ts, _ = tck.load_checkpoint(tbest)
    np.testing.assert_array_equal(np.asarray(params["dec0a_conv"]["kernel"]),
                                  tp["dec0a_conv"]["kernel"])
    np.testing.assert_array_equal(np.asarray(state["mida_bn"]["var"]),
                                  ts["mida_bn"]["var"])


def test_cross_validate_matches_jax(datasets, tmp_path, monkeypatch):
    """2 folds of 1 epoch: the same folds (``np.array_split``, the
    remainder spread over the first), the same aggregated keys, and each
    mean within the fit tolerances (std within twice them)."""
    kw = dict(FIT, nb_epochs=1, val_type="cross_validate", nb_folds=2)
    _no_plots(monkeypatch)
    jsplits = _spy_splits(monkeypatch, jseg.UNet1DSegmentation)
    tsplits = _spy_splits(monkeypatch, tseg.UNet1DSegmentation)
    jagg = _jax_model(tmp_path / "j").fit(datasets, **kw)
    tagg = _port_model(tmp_path / "t").fit(datasets, **kw)
    assert len(jsplits) == len(tsplits) == 2
    for (jt, jv), (tt, tv) in zip(jsplits, tsplits):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv, jv)
    assert sorted(tagg) == sorted(jagg)
    for k in jagg:
        assert sorted(tagg[k]) == ["trn_mean", "trn_std", "val_mean", "val_std"]
        tol = 0.25 if k == "ypspks" else 5e-3
        for stat in ("trn_mean", "val_mean"):
            assert abs(tagg[k][stat] - jagg[k][stat]) <= tol, (k, stat)
        for stat in ("trn_std", "val_std"):
            assert abs(tagg[k][stat] - jagg[k][stat]) <= 2 * tol, (k, stat)


def test_fit_draws_its_own_init_from_the_seed(datasets, tmp_path, caplog):
    """Without ``init_params`` the net is drawn on the CPU from the seed:
    at lr 0 the checkpoint holds exactly ``UNet1D``'s draw from it (through
    the perf preset's K=2 steps a call). The preset's K and the no-op PRNG
    knob are logged; the sample and metrics plots are written."""
    model = _port_model(tmp_path, init_params=None)
    with caplog.at_level(logging.INFO, logger=tseg.__name__):
        mt, mv, best = model.fit(datasets, preset="perf", prng_impl="rbg",
                                 **dict(FIT, nb_epochs=1, learning_rate=0.0))
    assert "preset='perf': steps_per_dispatch=2 (steps_trn=2)" in caplog.text
    assert "prng_impl='rbg': the JAX package's PRNG lever; a no-op here" \
        in caplog.text
    assert all(np.isfinite(v) for v in mv.values())
    files = os.listdir(tmp_path)
    assert any(f.endswith("_samples_000_val.png") for f in files)
    assert any(f.endswith("_metrics.png") for f in files)
    got = tck.load_checkpoint(best)[0]
    want, _ = to_jax_params(UNet1D(
        nfb=4, generator=torch.Generator().manual_seed(FIT["seed"])))
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_array_equal(got[layer][leaf], want[layer][leaf])


def test_fit_raises_on_a_non_finite_loss(datasets, tmp_path, monkeypatch):
    _no_plots(monkeypatch)

    def nan_traces(path):
        t = tseg.get_dataset_traces(path)
        t[:, ::7] = np.nan
        return t

    with pytest.raises(FloatingPointError, match="non-finite"):
        _port_model(tmp_path, dataset_traces_func=nan_traces).fit(
            datasets, **dict(FIT, nb_epochs=1))


# --- Keras weights -------------------------------------------------------------

@pytest.fixture(scope="module")
def keras_file(tmp_path_factory):
    """The file ``tests/test_keras_import.py::test_unet1d_import_roundtrip``
    writes: random Keras-layout UNet1D weights at nfb=4."""
    shapes, _ = jax.eval_shape(functools.partial(junet.init, nfb=4),
                               jax.random.PRNGKey(0))
    shapes = {k: {kk: vv.shape for kk, vv in v.items()} for k, v in shapes.items()}
    path = str(tmp_path_factory.mktemp("keras") / "unet1d_model.hdf5")
    _write_keras_h5(path, junet.layer_order(4), shapes, kind_1d=True)
    return path


@pytest.mark.parametrize("nfb", [None, 4])
def test_load_unet1d_keras_matches_jax(keras_file, nfb):
    params, state = tki.load_unet1d_keras(keras_file, nfb=nfb)
    jparams, jstate = jki.load_unet1d_keras(keras_file, nfb=nfb)
    for tree, jtree in ((params, jparams), (state, jstate)):
        assert sorted(tree) == sorted(jtree)
        for layer in jtree:
            assert sorted(tree[layer]) == sorted(jtree[layer])
            for leaf in jtree[layer]:
                assert tree[layer][leaf].dtype == np.float32
                np.testing.assert_array_equal(tree[layer][leaf],
                                              np.asarray(jtree[layer][leaf]))


def test_load_unet1d_keras_rejects_a_truncated_file(keras_file, tmp_path):
    path = str(tmp_path / "short.hdf5")
    with open(keras_file, "rb") as src, open(path, "wb") as dst:
        dst.write(src.read())
    with h5py.File(path, "a") as fp:
        names = list(fp["model_weights"].attrs["layer_names"])
        fp["model_weights"].attrs["layer_names"] = np.array(names[:-4])
    for load in (jki.load_unet1d_keras, tki.load_unet1d_keras):
        with pytest.raises(ValueError, match="ran out"):
            load(path, nfb=4)


def test_predict_from_keras_file_matches_jax(keras_file, datasets, tmp_path):
    jm, _ = _jax_model(tmp_path / "j").predict(datasets, keras_file, batch=8,
                                               fast=False)
    tm, names = _port_model(tmp_path / "t").predict(datasets, keras_file,
                                                    batch=8, fast=False)
    assert names == ["spikes.0", "spikes.1"]
    params, state = jki.load_unet1d_keras(keras_file)
    for p, a, b in zip(datasets, tm, jm):
        _assert_masks_close(a, b, _probs(params, state, p))


# --- knobs, accessors, helpers ----------------------------------------------

@pytest.mark.parametrize("kw,err,match", [
    (dict(shape=(4096, 1)), ValueError, "window_len"),
    (dict(shape=(1000,)), ValueError, "multiple of 16"),
    (dict(shape=(8,)), ValueError, "multiple of 16"),
    (dict(prop_trn=1.0, prop_val=0.0), ValueError, "lie in"),
    (dict(prop_trn=0.5, prop_val=0.2), ValueError, "must be 1"),
    (dict(val_type="kfold"), ValueError, "val_type"),
    (dict(nb_folds=1), ValueError, "nb_folds"),
    (dict(preset="fastest"), ValueError, "preset"),
    (dict(prng_impl="philox"), ValueError, "prng_impl"),
    (dict(steps_per_dispatch=0), ValueError, "steps_per_dispatch"),
    (dict(mesh=object()), TypeError, "multi-device"),
])
def test_fit_checks_knobs_before_any_dataset_io(tmp_path, kw, err, match):
    """A missing dataset would raise from h5py: each knob fails first, with
    the JAX package's message where it has one."""
    with pytest.raises(err, match=match):
        _port_model(tmp_path).fit(["/nonexistent/spikes.hdf5"], **kw)


def test_steps_per_dispatch_must_divide_the_steps(datasets, tmp_path):
    """As in JAX, after the split: 13 training traces, batch 8 -> 2 steps."""
    for model in (_jax_model(tmp_path / "j"), _port_model(tmp_path / "t")):
        with pytest.raises(ValueError, match="steps_per_dispatch"):
            model.fit(datasets, steps_per_dispatch=3, **dict(FIT, nb_epochs=1))


def test_predict_rejects_a_mesh(tmp_path):
    with pytest.raises(TypeError, match="multi-device"):
        _port_model(tmp_path).predict([], "model.ckpt", mesh=object())


def test_wrapper_needs_a_card_by_default():
    """No CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tseg.UNet1DSegmentation()


def test_accessors_match_jax(datasets):
    for p in datasets:
        assert tseg.get_dataset_attrs(p) == jseg.get_dataset_attrs(p)
        np.testing.assert_array_equal(tseg.get_dataset_traces(p),
                                      jseg.get_dataset_traces(p))
        np.testing.assert_array_equal(tseg.get_dataset_spikes(p),
                                      jseg.get_dataset_spikes(p))


@pytest.mark.parametrize("margin", [0, 1, 2, 4, 7])
def test_maxpool_labels_and_margin_metrics_match_jax(margin):
    """Odd and even windows on ragged lengths; the metrics of a prediction
    off by up to 3 samples (rtol 1e-6)."""
    rng = np.random.default_rng(margin)
    for t in (15, 16, 33):
        s = (rng.random((3, t)) < 0.2).astype(np.float32)
        got = tseg.maxpool_labels(s, margin)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jseg.maxpool_labels(s, margin))
        pred = np.roll(s, int(rng.integers(-3, 4)), axis=1)
        want = jseg.margin_metrics(s, pred, margin)
        out = tseg.margin_metrics(s, pred, margin)
        assert sorted(out) == sorted(want)
        for k in want:
            assert out[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k


def test_pad_to_multiple_matches_jax():
    x = np.arange(2 * 37, dtype=np.float32).reshape(2, 37)
    for mult in (16, 37):
        a, ta = tseg._pad_to_multiple(x, mult)
        b, tb = jseg._pad_to_multiple(x, mult)
        assert ta == tb == 37
        np.testing.assert_array_equal(a, b)


def test_plot_traces_spikes_writes_a_png(tmp_path):
    from deepcalcium_torch.utils.visualization import plot_traces_spikes

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64))
    y = (rng.random((3, 64)) < 0.1).astype(np.float32)
    path = str(tmp_path / "samples.png")
    plot_traces_spikes(x, spikes_true=y, spikes_pred=rng.random((3, 64)),
                       title="t", save_path=path)
    with open(path, "rb") as fp:
        assert fp.read(8) == b"\x89PNG\r\n\x1a\n"


def test_c2s_shim_raises_as_in_jax():
    from deepcalcium_tpu.models.c2s_segmentation import C2SSegmentation as J

    assert C2SSegmentation.DEPRECATION_REASON == J.DEPRECATION_REASON
    with pytest.raises(NotImplementedError, match="GLMSegmentation"):
        C2SSegmentation("anything", k=1)

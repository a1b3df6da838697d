"""``UNet2DSummary.fit`` of the port against the JAX package's, on the CPU,
on two ``data/fixtures.make_neurons_hdf5`` datasets.

Both packages train one epoch from one shared checkpoint at drp=0, float32,
on the same sampler batches (the sampler is the same numpy code and seed).
The shared checkpoint is the port's net after 3 short epochs: an untrained
net puts most pixels near 0.5, where the thresholded validation metrics
turn on rounding. The compared epoch runs at lr 1e-4: at Adam's eps 1e-8
the conv biases that feed a BN have a gradient that is zero up to rounding,
so each package walks them by up to lr per step in its own direction
(``tests/test_torch_train.py``); that leaves training untouched, but it
shifts the eval-mode output, by an amount that scales with lr.

Tolerances: train loss rtol 1e-3; the rounded train metrics atol 5e-3;
val_nf_* atol 1e-3, inside the 3 decimals of the checkpoint names, which
must be equal.
"""

import functools
import logging
import os

import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import make_neurons_hdf5
from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.models import unet_2d_summary as jsummary
from deepcalcium_tpu.train import checkpoints as jck
from deepcalcium_tpu.train import trainer as jtrainer
from deepcalcium_torch.models import unet_2d_summary as tsummary
from deepcalcium_torch.models.unet2d import UNet2DS
from deepcalcium_torch.train import checkpoints as tck

torch.set_num_threads(1)

TINY = functools.partial(UNet2DS, nfb=4, drp=0.0)
TRAIN = dict(shape_trn=(48, 48), shape_val=(96, 96), batch_size_trn=8)


def _port(cpdir, **kw):
    return tsummary.UNet2DSummary(cpdir=str(cpdir), device="cpu",
                                  net_func=TINY, **kw)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = tmp_path_factory.mktemp("nf")
    return [make_neurons_hdf5(str(d / f"ds{i}" / "dataset.hdf5"),
                              name=f"synthetic.00.0{i}", shape=(96, 96),
                              nb_frames=48, nb_neurons=8, seed=i)
            for i in range(2)]


@pytest.fixture(scope="module")
def runs(datasets, tmp_path_factory):
    """The shared start, then one epoch in each package."""
    d = tmp_path_factory.mktemp("fit")
    _, shared = _port(d / "pre").fit(datasets, nb_steps_trn=20, nb_epochs=3,
                                     seed=3, **TRAIN)
    kw = dict(model_path=shared, nb_steps_trn=10, nb_epochs=1, seed=7,
              learning_rate=1e-4, **TRAIN)
    jmodel = jsummary.UNet2DSummary(
        cpdir=str(d / "jax"), net_init_func=functools.partial(junet.init, nfb=4),
        net_apply_func=functools.partial(junet.apply, drp=0.0))
    jhist, jbest = jmodel.fit(datasets, fast_train=False, **kw)
    thist, tbest = _port(d / "port").fit(datasets, **kw)
    return {"shared": shared, "jax": (jhist, jbest), "port": (thist, tbest),
            "dir": d}


def test_fit_matches_jax_fit(runs):
    (jh, jbest), (th, tbest) = runs["jax"], runs["port"]
    assert list(th) == list(jh)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-3)
    for k in ("F1", "prec", "reca", "dice", "dicesq", "posyt", "posyp"):
        np.testing.assert_allclose(th[k], jh[k], rtol=0, atol=5e-3, err_msg=k)
    for k in [k for k in jh if k.startswith("val_nf_")]:
        np.testing.assert_allclose(th[k], jh[k], rtol=0, atol=1e-3, err_msg=k)
    # optax holds the lr in float32.
    np.testing.assert_allclose(th["lr"], jh["lr"], rtol=1e-6)
    tname, jname = (os.path.basename(p).split("_", 1)[1] for p in (tbest, jbest))
    assert tname == jname and tname.startswith("model_00_")
    assert sorted(os.listdir(os.path.dirname(tbest)))[0].endswith("_metrics.csv")


def test_port_fit_checkpoint_loads_in_jax(runs):
    """The port's checkpoint, with its Adam state, through the JAX
    package's reader with ``optimizer.init(params)`` as the template."""
    _, tbest = runs["port"]
    p0, s0 = junet.init(jax.random.PRNGKey(0), nfb=4)
    opt = jtrainer.make_optimizer(2e-3)
    params, state, opt_state, meta = jck.load_checkpoint(tbest, p0, s0,
                                                         opt.init(p0))
    assert int(opt_state.count) == 10 and meta["epoch"] == 0
    np.testing.assert_allclose(jtrainer.current_lr(opt_state), 1e-4, rtol=1e-6)
    tp, ts, _ = tck.load_checkpoint(tbest)
    np.testing.assert_array_equal(np.asarray(params["dec0a_conv"]["kernel"]),
                                  tp["dec0a_conv"]["kernel"])
    np.testing.assert_array_equal(np.asarray(state["up0_bn"]["var"]),
                                  ts["up0_bn"]["var"])


def test_jax_fit_checkpoint_resumes_in_port(runs, datasets):
    """``proceed=True`` from the JAX package's checkpoint restores Adam's
    moments, count and lr: after 2 more steps the count is 12."""
    _, jbest = runs["jax"]
    model = _port(runs["dir"] / "resume")
    hist, best = model.fit(datasets, model_path=jbest, proceed=True,
                           nb_steps_trn=2, nb_epochs=1, **TRAIN)
    opt_state = tck.read_checkpoint(best)["opt_state"]
    assert int(opt_state["count"]) == 12
    assert int(opt_state["inner_state"]["0"]["count"]) == 12
    assert hist["lr"] == [float(np.float32(1e-4))]
    # And "latest" resolves inside cpdir.
    hist2, best2 = model.fit(datasets, model_path="latest", proceed=True,
                             nb_steps_trn=2, nb_epochs=1, **TRAIN)
    assert int(tck.read_checkpoint(best2)["opt_state"]["count"]) == 14


def test_default_accessors_match_jax(datasets):
    for p in datasets:
        assert tsummary.name_dataset(p) == jsummary.name_dataset(p)
        np.testing.assert_array_equal(tsummary.summarize_series(p),
                                      jsummary.summarize_series(p))
        np.testing.assert_array_equal(tsummary.summarize_mask(p),
                                      jsummary.summarize_mask(p))


@pytest.mark.parametrize("kw,err", [
    (dict(shape_trn=(48, 32)), ValueError),
    (dict(shape_trn=(40, 40)), ValueError),
    (dict(shape_val=(8, 8)), ValueError),
    (dict(prop_trn=1.0), ValueError),
    (dict(proceed=True), ValueError),
    (dict(preset="fast"), ValueError),
    (dict(nb_steps_trn=5, steps_per_dispatch=2), ValueError),
    (dict(prng_impl="philox"), ValueError),
    (dict(fast_train="yes"), ValueError),
    (dict(lr_schedule="step"), ValueError),
    (dict(mesh=object()), TypeError),
    (dict(model_path="weights.hdf5"), FileNotFoundError),
    (dict(model_path="weights.ckpt"), FileNotFoundError),
    (dict(model_path="latest"), FileNotFoundError),
])
def test_fit_checks_knobs_before_any_dataset_io(tmp_path, kw, err):
    """A missing dataset would raise from h5py: each knob fails first."""
    with pytest.raises(err):
        _port(tmp_path).fit(["/nonexistent/dataset.hdf5"], **kw)


def test_fit_needs_a_card_by_default():
    """No CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsummary.UNet2DSummary()


def test_fit_options_run(datasets, tmp_path, caplog):
    """EMA, a callable lr schedule, AdamW, remat, adaptive sampling, a
    profile, epoch callbacks, the perf preset (K=2 steps a call) and the
    logged no-op knobs (the PRNG), on the CPU."""
    seen = []
    model = _port(tmp_path, remat=True)
    with caplog.at_level(logging.INFO, logger=tsummary.__name__):
        hist, best = model.fit(
            datasets, nb_steps_trn=2, nb_epochs=2, ema_decay=0.5,
            lr_schedule=lambda e: 1e-3 / (e + 1), weight_decay=1e-4,
            adaptive_sampling=True, profile_dir=str(tmp_path / "prof"),
            epoch_callbacks=[lambda e, logs: seen.append((e, logs["loss"]))],
            preset="perf", steps_per_dispatch=2, prng_impl="rbg", **TRAIN)
    assert "preset='perf': steps_per_dispatch=2 (K steps a call)" in caplog.text
    assert "prng_impl='rbg', fast_train='auto': PRNG and lane-packing " \
        "levers of the JAX package; no-ops here" in caplog.text
    assert [e for e, _ in seen] == [0, 1] and np.isfinite(hist["loss"]).all()
    assert hist["lr"] == [2e-3, 5e-4]
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "prof"))
    ckpts = sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt"))
    assert len(ckpts) == 2 and best in [str(tmp_path / f) for f in ckpts]
    assert "weight_decay" in tck.read_checkpoint(best)["opt_state"]["hyperparams"]
    cos, _ = _port(tmp_path / "cos").fit(datasets, nb_steps_trn=1, nb_epochs=2,
                                         lr_schedule="cosine", **TRAIN)
    assert cos["lr"] == [2e-3, pytest.approx(1e-4 + 0.5 * 1.9e-3)]


def test_fit_raises_on_a_non_finite_loss(datasets, tmp_path):
    def nan_series(path):
        s = tsummary.summarize_series(path)
        s[::7] = np.nan
        return s

    with pytest.raises(FloatingPointError, match="non-finite"):
        _port(tmp_path, series_summary_func=nan_series).fit(
            datasets, nb_steps_trn=2, nb_epochs=1, **TRAIN)

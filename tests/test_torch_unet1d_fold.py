"""``UNet1D.fold()`` and the spike ``predict(fast=)`` dispatch against the
JAX package, on the CPU at nfb=4, float32.

The folded net is the port's counterpart of the exact rewrites inside
``unet1d_fast.apply_fast_t``: BN folded into every conv, and the head as
float32 logits, the margin max-pool of both channels, then
``sigmoid(b - a)``. It is held against ``apply_fast_t(compute_dtype=None)``
and against the unfolded port net at the JAX test's own tolerance (atol
2e-6, rtol 1e-5, ``tests/test_unet1d_fast.py``). BN state is randomised as
that test randomises it, so the folds move every weight, and the heads get
biases of +-0.1, so that no probability sits at exactly 0.5.

``predict`` folds when ``fast is True``, or when ``fast == "auto"`` and the
built net is a ``UNet1D`` itself (the counterpart of ``net_apply_func is
unet1d.apply``); the masks equal the JAX ``predict``'s for each ``fast``.
"""

import copy
import functools
import logging

import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import make_spikes_hdf5
from deepcalcium_tpu.models import unet1d as junet
from deepcalcium_tpu.models import unet_1d_segmentation as jseg
from deepcalcium_tpu.models.unet1d_fast import apply_fast_t
from deepcalcium_torch.models import unet_1d_segmentation as tseg
from deepcalcium_torch.models.unet1d import (UNet1D, from_jax_params,
                                             to_jax_params)
from deepcalcium_torch.parallel import distributed as tdist
from deepcalcium_torch.train.checkpoints import save_checkpoint
from test_keras_import import _write_keras_h5

torch.set_num_threads(1)

TOL = dict(atol=2e-6, rtol=1e-5)
HEAD_BIAS = np.array([0.1, -0.1], np.float32)


def _np_tree(tree):
    return jax.tree.map(lambda v: np.asarray(v, np.float32), tree)


@pytest.fixture(scope="module")
def net():
    """(params, state) at nfb=4 as numpy: BN state randomised as
    ``tests/test_unet1d_fast.py`` does, head biases +-0.1."""
    params, state = junet.init(jax.random.PRNGKey(0), nfb=4)
    k = jax.random.PRNGKey(9)
    state = jax.tree.map(
        lambda v: v + 0.3 * jax.random.uniform(k, v.shape), state)
    params = dict(params, head_conv=dict(params["head_conv"],
                                         bias=HEAD_BIAS))
    return _np_tree(params), _np_tree(state)


def _x(t):
    return np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)


def _run(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("t", [64, 80])
@pytest.mark.parametrize("margin", [4, 2, 0])
def test_fold_matches_jax_apply_fast_t(net, t, margin):
    params, state = net
    x = _x(t)
    want, _ = apply_fast_t(params, state, x, margin=margin,
                           compute_dtype=None)
    got = _run(from_jax_params(params, state, margin=margin).fold(), x)
    assert got.shape == (2, t) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [64, 80])
@pytest.mark.parametrize("margin", [4, 2, 0])
def test_fold_matches_unfolded(net, t, margin):
    model = from_jax_params(*net, margin=margin)
    x = _x(t + 1)[:, :t]
    np.testing.assert_allclose(_run(model.fold(), x), _run(model, x), **TOL)


def test_fold_leaves_no_bn_and_keeps_the_original(net):
    model = from_jax_params(*net)
    folded = model.fold()
    assert folded.folded and not model.folded
    assert folded.fold() is folded
    names = [n for n, _ in folded.named_children()]
    assert not any(n.endswith("_bn") for n in names)
    assert sum(n.endswith("_conv") for n in names) == 19
    assert not any(n.endswith("_bn") for n in folded.state_dict())
    # The unfolded net still has its BN and its weights.
    params, _ = to_jax_params(model)
    np.testing.assert_array_equal(params["enc0a_conv"]["kernel"],
                                  net[0]["enc0a_conv"]["kernel"])
    assert sum(n.endswith("_bn") for n, _ in model.named_children()) == 18


def test_folded_net_refuses_to_train_or_export(net):
    folded = from_jax_params(*net, drp=0.0).fold()
    with pytest.raises(ValueError, match="no BN to train"):
        folded(torch.zeros(1, 32), train=True)
    for export in (to_jax_params, lambda m: m.jax_tree()):
        with pytest.raises(ValueError, match="no BN layers to export"):
            export(folded)


def test_fold_is_computed_in_float32_and_cast_at_the_conv(net):
    """The folded weights stay float32; a bf16 net casts them at each conv
    and still computes its head in float32."""
    model = from_jax_params(*net, compute_dtype=torch.bfloat16).fold()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = _x(64)
    got = _run(model, x)
    assert got.dtype == np.float32
    want = _run(from_jax_params(*net).fold(), x)
    np.testing.assert_allclose(got, want, atol=0.05)


@pytest.mark.parametrize("margin", [4, 0])
def test_double_net_runs_float64_end_to_end(net, margin):
    """Cast with ``.double()``, the unfolded and the folded net run float64
    throughout, head included: the float64 reference that splits the
    float32 gap between the two. The float32 nets lie within TOL of it,
    and the two float64 forwards differ only by the fold's float32
    rounding of the weights."""
    model = from_jax_params(*net, margin=margin)
    folded = model.fold()
    x = _x(64)
    x64 = torch.from_numpy(x).double()
    with torch.no_grad():
        ref = copy.deepcopy(model).double()(x64).numpy()
        fold64 = copy.deepcopy(folded).double()(x64).numpy()
    assert ref.dtype == fold64.dtype == np.float64
    np.testing.assert_allclose(_run(model, x), ref, **TOL)
    np.testing.assert_allclose(_run(folded, x), ref, **TOL)
    np.testing.assert_allclose(fold64, ref, atol=1e-6, rtol=1e-6)


# --- predict(fast=) against the JAX package ------------------------------------

@pytest.fixture(scope="module")
def files(net, tmp_path_factory):
    """A checkpoint of ``net``, a Keras file of random weights at nfb=4
    (``tests/test_torch_spikes.py``'s), and two spike datasets."""
    d = tmp_path_factory.mktemp("fold")
    ckpt = str(d / "m1d.ckpt")
    save_checkpoint(ckpt, *net)
    shapes, _ = jax.eval_shape(functools.partial(junet.init, nfb=4),
                               jax.random.PRNGKey(0))
    shapes = {k: {kk: vv.shape for kk, vv in v.items()}
              for k, v in shapes.items()}
    keras = str(d / "unet1d_model.hdf5")
    _write_keras_h5(keras, junet.layer_order(4), shapes, kind_1d=True)
    datasets = [make_spikes_hdf5(str(d / f"sp{i}.hdf5"), name=f"spikes.{i}",
                                 nb_traces=8, trace_len=256 - 40 * i, seed=i)
                for i in range(2)]
    return {"ckpt": ckpt, "keras": keras, "datasets": datasets, "dir": d}


def _jax_predict(files, source, fast):
    model = jseg.UNet1DSegmentation(
        cpdir=str(files["dir"] / "j"),
        net_init_func=functools.partial(junet.init, nfb=4))
    return model.predict(files["datasets"], files[source], batch=8, fast=fast)


@pytest.fixture(scope="module")
def jax_masks(files):
    return {(s, f): _jax_predict(files, s, f)
            for s in ("ckpt", "keras") for f in (True, "auto", False)}


def _port(files, **kw):
    return tseg.UNet1DSegmentation(cpdir=str(files["dir"] / "t"),
                                   device="cpu", **kw)


def _probs(files, net, source, fold):
    """The port's float32 probabilities of every trace, for the margin to
    the threshold."""
    if source == "ckpt":
        params, state = net
    else:
        from deepcalcium_torch.interop.keras_import import load_unet1d_keras

        params, state = load_unet1d_keras(files["keras"])
    model = from_jax_params(params, state, margin=4)
    model = model.fold() if fold else model
    out = []
    for p in files["datasets"]:
        traces = tseg.get_dataset_traces(p).astype(np.float32)
        padded, t = tseg._pad_to_multiple(traces, 16)
        out.append(_run(model, padded)[:, :t])
    return out


@pytest.mark.parametrize("source", ["ckpt", "keras"])
@pytest.mark.parametrize("fast", [True, "auto", False])
@pytest.mark.parametrize("net_func", ["stock", "partial"])
def test_predict_fast_matches_jax(net, files, jax_masks, source, fast,
                                  net_func, caplog):
    """The port's masks equal the JAX ``predict``'s for the same ``fast``,
    on a checkpoint and on a Keras file. ``functools.partial(UNet1D,
    nfb=4)`` counts as the stock net. The two forwards agree within TOL, so
    the masks are equal wherever the port's probability lies further than
    that from the threshold (every sample but a handful, if any), and both
    classes occur."""
    kw = {} if net_func == "stock" else {
        "net_func": functools.partial(UNet1D, nfb=4)}
    with caplog.at_level(logging.INFO, logger=tseg.__name__):
        got, names = _port(files, **kw).predict(files["datasets"],
                                                files[source], batch=8,
                                                fast=fast)
    folded = "running the folded inference forward" in caplog.text
    assert folded == (fast is not False)
    want, jnames = jax_masks[(source, fast)]
    assert names == jnames == ["spikes.0", "spikes.1"]
    for a, b, p in zip(got, want, _probs(files, net, source, folded)):
        far = np.abs(p - 0.5) > TOL["atol"]
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert far.sum() >= far.size - 2 and 0 < a.sum() < a.size
        np.testing.assert_array_equal(a[far], b[far])


def test_predict_under_a_one_rank_mesh_is_bitwise_without(files):
    """The meshed predict runs the folded net too: each slab split over a
    gloo group of one rank and gathered gives the same masks."""
    model = _port(files)
    want, _ = model.predict(files["datasets"], files["ckpt"], batch=5)
    tdist.initialize(f"127.0.0.1:{tdist._free_port()}", 1, 0, backend="gloo")
    try:
        got, _ = model.predict(files["datasets"], files["ckpt"], batch=5,
                               mesh=tdist.pod_mesh())
    finally:
        tdist.shutdown()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


class _CountingUNet1D(UNet1D):
    """A custom net: a ``UNet1D`` subclass that counts its forwards."""

    calls = 0

    def forward(self, x, *a, **kw):
        type(self).calls += 1
        return super().forward(x, *a, **kw)


@pytest.mark.parametrize("fast", ["auto", True])
def test_predict_builds_through_net_func(files, fast, caplog):
    """A custom ``net_func`` runs in ``predict``; under "auto" it is not
    folded (as a custom ``net_apply_func`` is not in JAX), and ``fast=True``
    folds it. Its masks are the stock net's."""
    _CountingUNet1D.calls = 0
    model = _port(files, net_func=functools.partial(_CountingUNet1D, nfb=4))
    with caplog.at_level(logging.INFO, logger=tseg.__name__):
        got, _ = model.predict(files["datasets"], files["ckpt"], batch=8,
                               fast=fast)
    assert _CountingUNet1D.calls == 2  # one slab of 8 traces a dataset
    assert ("running the folded inference forward" in caplog.text) == (
        fast is True)
    want, _ = _port(files).predict(files["datasets"], files["ckpt"], batch=8,
                                   fast=fast is True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

"""The port's GLM/STM spike baselines against the JAX package's, on the CPU:
the model functions on the same params and traces, full-batch fits from the
same initial params over ragged datasets, ``predict`` and
``predict_rates``, the checkpoint files (the GLM's 0-d bias included, byte
for byte), and the guards.

Tolerances: the model functions rtol 1e-5, atol 1e-6 (float32 convolutions
summed in another order); after a few full-batch Adam epochs params rtol
1e-4, atol 1e-6 (Adam divides by the gradient's root mean square, which
carries the sums' rounding); the metrics of the fits atol 2e-3 (a sample
whose probability differs in the last bits crossing 0.5); predicted masks
equal away from 1e-4 of the threshold; rates rtol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data.fixtures import make_spikes_hdf5
from deepcalcium_tpu.models import glm_spikes as jglm
from deepcalcium_tpu.train import checkpoints as jck
from deepcalcium_torch.models import glm_spikes as tglm
from deepcalcium_torch.train import checkpoints as tck

torch.set_num_threads(1)

K = 21


def _params(arch, seed=0, k=K):
    """numpy params of either model, drawn from numpy: the STM's as its
    init draws them (scale 0.05, biases -2); the GLM's filter 10x its
    init's scale and its bias off zero, so the model is far from trivial."""
    rng = np.random.default_rng(seed)
    if arch == "glm":
        return {"w": (rng.standard_normal(k) * 0.1).astype(np.float32),
                "b": np.float32(-0.3) * np.ones((), np.float32)}
    return {"U": (rng.standard_normal((k, 2)) * 0.05).astype(np.float32),
            "W": (rng.standard_normal((k, 3)) * 0.05).astype(np.float32),
            "beta": (rng.standard_normal((2, 3)) * 0.05).astype(np.float32),
            "a": np.full(3, -2.0, np.float32)}


def _tensors(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _traces(seed=1, shape=(3, 200)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = (rng.random(shape) < 0.05).astype(np.float32)
    return x, y


def test_model_functions_match_jax():
    x, y = _traces()
    g, s = _params("glm"), _params("stm")
    pairs = [
        (jglm.glm_apply(g, x), tglm.glm_apply(_tensors(g), torch.from_numpy(x))),
        (jglm.stm_log_rate(s, x), tglm.stm_log_rate(_tensors(s), torch.from_numpy(x))),
        (jglm.stm_apply(s, x), tglm.stm_apply(_tensors(s), torch.from_numpy(x))),
        (jglm.stm_poisson_nll(s, x, y),
         tglm.stm_poisson_nll(_tensors(s), torch.from_numpy(x), torch.from_numpy(y))),
    ]
    for ref, out in pairs:
        assert out.dtype == torch.float32 and tuple(out.shape) == np.shape(ref)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_stm_clips_the_log_rate_as_jax():
    """Huge traces push the log-rate past 15: the rate is clipped at
    exp(15), and P(spike) saturates at 1, in both packages."""
    x = np.linspace(-200, 200, 64, dtype=np.float32)[None]
    s = _params("stm")
    s["W"][:] = 1.0
    ref = np.asarray(jglm.stm_apply(s, x))
    out = tglm.stm_apply(_tensors(s), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    assert out.max() == 1.0


def test_init_shapes_and_guards():
    g = torch.Generator().manual_seed(0)
    jg = jglm.glm_init(jax.random.PRNGKey(0), 41)
    tg = tglm.glm_init(g, 41)
    assert {k: tuple(v.shape) for k, v in tg.items()} == \
        {k: tuple(np.shape(v)) for k, v in jg.items()}
    assert tg["b"].dim() == 0 and tg["b"].dtype == torch.float32
    js = jglm.stm_init(jax.random.PRNGKey(0), 41, 2, 3)
    ts = tglm.stm_init(g, 41, 2, 3)
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: tuple(np.shape(v)) for k, v in js.items()}
    np.testing.assert_array_equal(ts["a"].numpy(), np.asarray(js["a"]))
    for init in (tglm.glm_init, tglm.stm_init):
        with pytest.raises(ValueError, match="odd"):
            init(g, 40)
    with pytest.raises(ValueError, match="arch"):
        tglm.GLMSegmentation(arch="lstm", device="cpu")


def test_checkpoint_bytes_equal_flax(tmp_path):
    """The same GLM params and meta written by each package: the same
    bytes, the 0-d bias an ndarray leaf of shape () in both; read back by
    the port as a 0-d float32 array."""
    p = _params("glm")
    meta = {"val_F2": 0.4375, "arch": "glm"}
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jck.save_checkpoint(jpath, {k: jnp.asarray(v) for k, v in p.items()}, {},
                        meta=meta)
    tck.save_checkpoint(tpath, _tensors(p), {}, meta=meta)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    raw = tck.read_checkpoint(tpath)
    assert raw["params"]["b"].shape == () and raw["params"]["b"].dtype == np.float32
    assert raw["meta"] == meta and raw["state"] == {}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Two datasets of different trace lengths (ragged): the fit pads and
    masks."""
    d = tmp_path_factory.mktemp("glm")
    return [make_spikes_hdf5(str(d / f"g{i}.hdf5"), name=f"g.{i}",
                             nb_traces=6, trace_len=256 - 56 * i, seed=20 + i)
            for i in range(2)]


def _same_init(monkeypatch, arch):
    p = _params(arch, seed=3)
    monkeypatch.setattr(jglm.GLMSegmentation, "_init",
                        lambda self, key: {k: jnp.asarray(v) for k, v in p.items()})
    monkeypatch.setattr(tglm.GLMSegmentation, "_init",
                        lambda self, seed: _tensors(p))


@pytest.mark.parametrize("arch", ["glm", "stm"])
def test_fit_predict_match_jax(arch, datasets, tmp_path, monkeypatch):
    """8 full-batch epochs from the same params on ragged datasets: the
    same params and metrics; then predict (and predict_rates for the STM)
    from each package's checkpoint in the other."""
    _same_init(monkeypatch, arch)
    kw = dict(filter_len=K, arch=arch)
    jmodel = jglm.GLMSegmentation(cpdir=str(tmp_path / "j"), **kw)
    tmodel = tglm.GLMSegmentation(cpdir=str(tmp_path / "t"), device="cpu", **kw)
    fit = dict(nb_epochs=8, error_margin=4, seed=1, learning_rate=1e-2)
    jmt, jmv, jpath = jmodel.fit(datasets, **fit)
    tmt, tmv, tpath = tmodel.fit(datasets, **fit)
    jraw, traw = tck.read_checkpoint(jpath), tck.read_checkpoint(tpath)
    assert traw["meta"]["arch"] == jraw["meta"]["arch"] == arch
    assert os.path.basename(tpath).endswith(f"_{arch}.ckpt")
    assert sorted(traw["params"]) == sorted(jraw["params"])
    for k, v in jraw["params"].items():
        assert traw["params"][k].shape == v.shape
        np.testing.assert_allclose(traw["params"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    init = _params(arch, seed=3)
    assert not np.allclose(traw["params"][sorted(init)[0]], init[sorted(init)[0]])
    for got, want in ((tmt, jmt), (tmv, jmv)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])

    for path in (jpath, tpath):
        jm, jn = jmodel.predict(datasets, path)
        tm, tn = tmodel.predict(datasets, path)
        assert tn == jn == ["g.0", "g.1"]
        params = {k: jnp.asarray(v) for k, v in tck.read_checkpoint(path)["params"].items()}
        for p, a, b in zip(datasets, tm, jm):
            x = jglm.get_dataset_traces(p)
            probs = np.asarray(jmodel._apply(params, jnp.asarray(x, jnp.float32)))
            far = np.abs(probs - 0.5) >= 1e-4
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == x.shape
            np.testing.assert_array_equal(a[far], b[far])
        if arch == "stm":
            jr, _ = jmodel.predict_rates(datasets, path)
            tr, _ = tmodel.predict_rates(datasets, path)
            for a, b in zip(tr, jr):
                assert a.dtype == np.float32 and (a >= 0).all()
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_guards_match_jax(datasets, tmp_path):
    """An empty split, nb_epochs < 1, a checkpoint of the other arch, and
    predict_rates on the GLM raise in both packages."""
    one = make_spikes_hdf5(str(tmp_path / "one.hdf5"), nb_traces=1,
                           trace_len=128, seed=4)
    models = {"jax": jglm.GLMSegmentation(cpdir=str(tmp_path / "j"),
                                          filter_len=K),
              "port": tglm.GLMSegmentation(cpdir=str(tmp_path / "t"),
                                           filter_len=K, device="cpu")}
    for m in models.values():
        with pytest.raises(ValueError, match="empty split"):
            m.fit([one])
        with pytest.raises(ValueError, match="nb_epochs"):
            m.fit(datasets, nb_epochs=0)
    _, _, stm_ckpt = tglm.GLMSegmentation(
        cpdir=str(tmp_path / "s"), filter_len=K, arch="stm",
        device="cpu").fit(datasets, nb_epochs=2)
    for name, m in models.items():
        with pytest.raises(ValueError):
            m.predict(datasets, stm_ckpt)
        with pytest.raises(ValueError, match="stm"):
            m.predict_rates(datasets, stm_ckpt)
    with pytest.raises(ValueError, match="arch"):
        models["port"].predict(datasets, stm_ckpt)


def test_fit_raises_on_divergence(datasets, tmp_path):
    def nan_traces(path):
        t = jglm.get_dataset_traces(path)
        t[0, 3] = np.nan
        return t

    model = tglm.GLMSegmentation(cpdir=str(tmp_path), filter_len=K,
                                 device="cpu", dataset_traces_func=nan_traces)
    with pytest.raises(FloatingPointError, match="diverged"):
        model.fit(datasets, nb_epochs=2)


def test_wrapper_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tglm.GLMSegmentation()

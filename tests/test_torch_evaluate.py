"""The port's movie evaluator, TTA helpers, reflect-pad and UNet2DSummary
wrapper against the JAX package's, on the same movies and weights (CPU,
float32).

Tolerances: prob at rtol=1e-4, atol=1e-5. The mean images agree to 1 ulp
(XLA divides by T through 1/T), and the forwards sum in another order.
Masks must agree except where |prob - 0.5| < 1e-4, where that difference
may flip the threshold.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.ops import augment as jaug
from deepcalcium_tpu.train import evaluate as jev
from deepcalcium_torch.models.unet2d import (UNet2DS, from_jax_params,
                                             to_jax_params)
from deepcalcium_torch.ops import augment as taug
from deepcalcium_torch.train import evaluate as tev

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def tiny_net():
    """nfb=4 weights in the JAX layout, drawn by the port from a seed."""
    return to_jax_params(
        UNet2DS(nfb=4, generator=torch.Generator().manual_seed(3)))


@pytest.fixture(scope="module")
def movie():
    rng = np.random.default_rng(7)
    return rng.integers(0, 1500, (20, 48, 48)).astype(np.int16)


def _jax_eval(params, state, movie, window, tta):
    apply_fn = functools.partial(junet.apply, compute_dtype=None,
                                 precision=HIGHEST)
    ev = jev.make_movie_evaluator(apply_fn, movie.shape, window=window,
                                  tta=tta)
    return [np.asarray(a) for a in ev(params, state, movie)]


def _port_eval(params, state, movie, window, tta):
    model = from_jax_params(params, state).eval()
    ev = tev.make_movie_evaluator(model, movie.shape, window=window, tta=tta)
    return [a.numpy() for a in ev(torch.from_numpy(movie))]


def _assert_masks_agree(mask, ref_mask, prob):
    differ = mask != ref_mask
    assert not (differ & (np.abs(prob - 0.5) >= 1e-4)).any()


@pytest.mark.parametrize("tta", [True, False])
def test_movie_evaluator_matches_jax(tiny_net, movie, tta):
    mask, prob, mean = _port_eval(*tiny_net, movie, (48, 48), tta)
    jmask, jprob, jmean = _jax_eval(*tiny_net, movie, (48, 48), tta)
    assert mask.dtype == np.uint8 and prob.dtype == np.float32
    np.testing.assert_array_max_ulp(mean, jmean, maxulp=1)
    np.testing.assert_allclose(prob, jprob, rtol=1e-4, atol=1e-5)
    _assert_masks_agree(mask, jmask, prob)


def test_movie_evaluator_pads_smaller_frames(tiny_net):
    rng = np.random.default_rng(1)
    mv = rng.integers(0, 1000, (8, 40, 44)).astype(np.int16)
    for tta in (False, True):
        mask, prob, _ = _port_eval(*tiny_net, mv, (48, 48), tta)
        jmask, jprob, _ = _jax_eval(*tiny_net, mv, (48, 48), tta)
        assert mask.shape == (40, 44) and prob.shape == (40, 44)
        np.testing.assert_allclose(prob, jprob, rtol=1e-4, atol=1e-5)
        _assert_masks_agree(mask, jmask, prob)


def test_constant_movie_gives_finite_probs(tiny_net):
    """A dead recording: z = 0 everywhere, not NaN, so prob is the net's
    output on a zero image.

    Held against the JAX forward on a zero image, not against the JAX
    evaluators: inside their fused graphs the same constant image gets a
    std of about 5e-6 from float rounding and z of about +-1 instead of 0
    (ROADMAP, Queue 3)."""
    mv = np.full((5, 48, 48), 321, np.int16)
    mask, prob, mean = _port_eval(*tiny_net, mv, (48, 48), True)
    assert (mean == 321).all() and np.isfinite(prob).all()
    ref, _ = junet.apply(*tiny_net, np.zeros((1, 48, 48), np.float32),
                         precision=HIGHEST)
    ref = np.asarray(ref)[0]
    np.testing.assert_allclose(prob, ref, rtol=1e-4, atol=1e-5)
    _assert_masks_agree(mask, (ref > 0.5).astype(np.uint8), prob)


def test_evaluator_rejects_bad_geometry(tiny_net):
    model = from_jax_params(*tiny_net)
    with pytest.raises(ValueError, match="larger than window"):
        tev.make_movie_evaluator(model, (4, 64, 64), window=(48, 48))
    with pytest.raises(ValueError, match="square window"):
        tev.make_movie_evaluator(model, (4, 32, 48), window=(32, 48))
    ev = tev.make_movie_evaluator(model, (4, 32, 32), window=(32, 32))
    with pytest.raises(ValueError, match="built for"):
        ev(torch.zeros((5, 32, 32), dtype=torch.int16))


@pytest.mark.parametrize("shape,window", [
    ((200, 200), (512, 512)),   # pads larger than the image
    ((5, 7), (48, 48)),         # many reflections
    ((40, 44), (48, 48)),
    ((1, 3), (4, 9)),           # a length-1 axis repeats its element
    ((16, 16), (16, 16)),       # no pad
])
def test_reflect_pad_to_matches_np_pad(shape, window):
    img = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    out = tev.reflect_pad_to(torch.from_numpy(img), *window).numpy()
    np.testing.assert_array_equal(out, jev.reflect_pad_to(img, *window))
    np.testing.assert_array_equal(
        out, np.pad(img, ((0, window[0] - shape[0]), (0, window[1] - shape[1])),
                    mode="reflect"))


def test_tta_expand_collapse_match_jax():
    assert taug.AUGMENTATION_NAMES == jaug.AUGMENTATION_NAMES
    np.testing.assert_array_equal(taug.D4_TABLE, jaug.D4_TABLE)
    np.testing.assert_array_equal(taug.D4_INVERSE, jaug.D4_INVERSE)
    x = np.random.default_rng(2).standard_normal((3, 16, 16)).astype(np.float32)
    views = taug.tta_expand(torch.from_numpy(x))
    np.testing.assert_array_equal(views.numpy(), np.asarray(jaug.tta_expand(x)))
    preds = np.random.default_rng(3).standard_normal((8, 3, 16, 16)).astype(
        np.float32)
    np.testing.assert_allclose(taug.tta_collapse(torch.from_numpy(preds)).numpy(),
                               np.asarray(jaug.tta_collapse(preds)),
                               rtol=1e-6, atol=1e-7)
    # Collapsing the expanded views inverts every view exactly.
    np.testing.assert_allclose(taug.tta_collapse(views).numpy(), x,
                               rtol=1e-6, atol=1e-7)


def _jax_wrapper(tmp_path):
    from deepcalcium_tpu.models.unet_2d_summary import UNet2DSummary

    return UNet2DSummary(cpdir=str(tmp_path / "jcp"),
                         net_init_func=functools.partial(junet.init, nfb=4))


def test_unet2dsummary_evaluate_movie_matches_jax(tmp_path, tiny_net, movie):
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary

    params, state = tiny_net
    jmask, jprob = _jax_wrapper(tmp_path).evaluate_movie(
        movie, params=params, state=state, window_shape=(48, 48))
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), device="cpu")
    mask, prob = model.evaluate_movie(movie, params=params, state=state,
                                      window_shape=(48, 48))
    assert isinstance(mask, np.ndarray) and mask.shape == (48, 48)
    np.testing.assert_allclose(prob, jprob, rtol=1e-4, atol=1e-5)
    _assert_masks_agree(mask, jmask, prob)

    # The same weights from a checkpoint written by the JAX package, through
    # model_path and "latest".
    from deepcalcium_tpu.train.checkpoints import save_checkpoint

    save_checkpoint(str(tmp_path / "cp" / "w.ckpt"), params, state)
    for path in (str(tmp_path / "cp" / "w.ckpt"), "latest"):
        m2, p2 = model.evaluate_movie(movie, model_path=path,
                                      window_shape=(48, 48))
        np.testing.assert_array_equal(p2, prob)
        np.testing.assert_array_equal(m2, mask)


def test_unet2dsummary_refuses_what_is_not_ported(tmp_path, tiny_net, movie):
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary

    params, state = tiny_net
    model = UNet2DSummary(cpdir=str(tmp_path / "cp"), device="cpu")
    # HDF5 paths, Keras weights, frames larger than the window and a mesh
    # are ported; anything but a Mesh is refused before any file is read.
    with pytest.raises(FileNotFoundError):
        model.evaluate_movie(str(tmp_path / "m.hdf5"), params=params,
                             state=state)
    mask, prob = model.evaluate_movie(movie, params=params, state=state,
                                      window_shape=(32, 32))
    assert mask.shape == prob.shape == movie.shape[1:]
    with pytest.raises(FileNotFoundError):
        model.evaluate_movie(movie, model_path=str(tmp_path / "w.hdf5"))
    with pytest.raises(TypeError, match="Mesh"):
        model.predict([], str(tmp_path / "w.hdf5"), mesh=object())
    with pytest.raises(ValueError, match="without state"):
        model.evaluate_movie(movie, params=params)
    with pytest.raises(FileNotFoundError):
        model.evaluate_movie(movie, model_path="latest")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            UNet2DSummary(cpdir=str(tmp_path / "cp"))


@pytest.mark.parametrize("max_batch", [None, 2])
def test_predict_batched_matches_jax(tiny_net, max_batch):
    """Images of several sizes (a rot90 view among them), reflect-padded to
    one window, run in slabs and cropped back: prob rtol 1e-4, atol 1e-5."""
    from deepcalcium_tpu.train.trainer import make_eval_forward
    from deepcalcium_torch.train.trainer import make_eval_forward as tfwd

    params, state = tiny_net
    rng = np.random.default_rng(4)
    base = rng.standard_normal((40, 48)).astype(np.float32)
    images = [base, np.rot90(base), np.fliplr(base),
              rng.standard_normal((48, 48)).astype(np.float32), base[:17, :30]]
    apply_fn = functools.partial(junet.apply, compute_dtype=None,
                                 precision=HIGHEST)
    ref = jev.predict_batched(make_eval_forward(apply_fn), params, state,
                              images, window=(48, 48), max_batch=max_batch)
    out = tev.predict_batched(tfwd(from_jax_params(params, state)), images,
                              "cpu", window=(48, 48), max_batch=max_batch)
    for o, r, img in zip(out, ref, images):
        assert o.shape == img.shape and o.dtype == np.float32
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-5)

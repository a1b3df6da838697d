"""The port's streaming fold, ``StreamingSummary``, streaming and tiled
evaluate, ``tile_grid`` and ``predict_tiled`` against the JAX package's, on
the CPU at nfb=4 and 48x48 windows.

Tolerances:
- the plain fold, finalised, is bitwise equal to ``movie_summary`` over any
  chunking for integer movies (both sums are exact), within 1 ulp for
  float32 (float64 partial sums grouped differently);
- ``StreamingSummary`` against the JAX host backend: mean rtol 1e-5,
  atol 1e-4, because JAX accumulates in float32 and the port exactly; max
  equal;
- streaming and tiled evaluate (the tolerances of
  ``tests/test_evaluate_movie.py``): mean as above, prob rtol 1e-4,
  atol 1e-5, mask equal;
- ``tile_grid`` equal, errors included; ``predict_tiled`` prob rtol 1e-4,
  atol 1e-5 (forwards summing in another order).
"""

import functools

import h5py
import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.ops import summary as jsummary
from deepcalcium_tpu.train import evaluate as jev
from deepcalcium_tpu.train import trainer as jtrainer
from deepcalcium_torch.models.unet2d import UNet2DS, from_jax_params, to_jax_params
from deepcalcium_torch.ops import summary as tsummary
from deepcalcium_torch.train import evaluate as tev

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST
JAX_APPLY = functools.partial(junet.apply, compute_dtype=None, precision=HIGHEST)
WINDOW = (48, 48)

# (name, shape, dtype, low, high); float movies draw normals * high + low.
MOVIES = [
    ("int16", (37, 24, 40), np.int16, -100, 3000),
    ("int16_ragged_hw", (31, 19, 137), np.int16, -100, 3000),
    ("uint16", (13, 9, 64), np.uint16, 0, 65536),
    ("float32", (10, 8, 130), np.float32, -5.0, 100.0),
]


def _movie(case, seed=865):
    _, shape, dtype, lo, hi = case
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal(shape) * hi + lo).astype(dtype)
    return rng.integers(lo, hi, shape).astype(dtype)


def _poison(dtype):
    return np.finfo(dtype).max if np.dtype(dtype).kind == "f" else np.iinfo(dtype).max


@pytest.mark.parametrize("chunk", [1, 5, 8, 64])
@pytest.mark.parametrize("case", MOVIES, ids=[c[0] for c in MOVIES])
def test_plain_fold_matches_movie_summary(case, chunk):
    """Ragged chunks through one fixed-size staging buffer whose frames past
    n_valid hold the dtype's maximum: never read."""
    movie = _movie(case)
    t = movie.shape[0]
    total, mx = tsummary.fold_accumulators(movie.shape[1:],
                                           torch.from_numpy(movie).dtype, "cpu")
    stage = np.full((chunk,) + movie.shape[1:], _poison(movie.dtype), movie.dtype)
    for i in range(0, t, chunk):
        n = min(chunk, t - i)
        stage[:n] = movie[i:i + n]
        stage[n:] = _poison(movie.dtype)
        tsummary.movie_fold(torch.from_numpy(stage), n, total, mx)
    mean = tsummary.finalise_fold(total, t).numpy()
    ref_mean, ref_max = (a.numpy() for a in
                         tsummary.movie_summary(torch.from_numpy(movie)))
    np.testing.assert_array_equal(mx.numpy(), ref_max.astype(np.float32))
    if movie.dtype.kind == "f":
        np.testing.assert_array_max_ulp(mean, ref_mean, maxulp=1)
    else:
        np.testing.assert_array_equal(mean, ref_mean)


def test_fold_rejects_what_it_does_not_take():
    chunk = torch.zeros((4, 3, 5), dtype=torch.int16)
    total, mx = tsummary.fold_accumulators((3, 5), torch.int16, "cpu")
    for n in (0, 5):
        with pytest.raises(ValueError, match="n_valid"):
            tsummary.movie_fold(chunk, n, total, mx)
    with pytest.raises(TypeError, match="totals"):
        tsummary.movie_fold(chunk, 2, total.double(), mx)
    with pytest.raises(TypeError, match="running max"):
        tsummary.movie_fold(chunk, 2, total, mx.double())
    with pytest.raises(ValueError, match="do not match"):
        tsummary.movie_fold(chunk, 2, total[:2], mx[:2])
    with pytest.raises(ValueError, match="CUDA"):
        tsummary.movie_fold_cuda(chunk, 2, total, mx)
    before = tsummary.movie_fold_cuda.launches
    tsummary.movie_fold_fast(chunk, 2, total, mx)  # CPU: the plain fold
    assert tsummary.movie_fold_cuda.launches == before


@pytest.mark.parametrize("case", MOVIES, ids=[c[0] for c in MOVIES])
def test_streaming_summary_matches_jax_host(case):
    movie = _movie(case)
    js = jsummary.StreamingSummary(movie.shape[1:], dtype=movie.dtype,
                                   backend="host")
    ts = tsummary.StreamingSummary(movie.shape[1:], dtype=movie.dtype,
                                   device="cpu")
    for i in range(0, movie.shape[0], 7):
        js.update(movie[i:i + 7])
        ts.update(movie[i:i + 7])
    jmean, jmax = js.result()
    mean, mx = ts.result()
    assert mean.dtype == np.float32 and mx.dtype == movie.dtype
    np.testing.assert_allclose(mean, jmean, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(mx, jmax)
    # And exactly the one-call summary.
    ref_mean, ref_max = tsummary.movie_summary(torch.from_numpy(movie))
    np.testing.assert_array_equal(mx, ref_max.numpy())
    if movie.dtype.kind != "f":
        np.testing.assert_array_equal(mean, ref_mean.numpy())


def test_streaming_summary_splits_and_skips_the_max():
    """A chunk longer than the first one seen is split; track_max=False
    returns no max; no frames raises; a tensor chunk folds too."""
    movie = _movie(MOVIES[0])
    ts = tsummary.StreamingSummary(movie.shape[1:], dtype=np.int16,
                                   device="cpu", track_max=False)
    with pytest.raises(ValueError, match="no frames"):
        ts.result()
    ts.update(movie[:4])
    ts.update(movie[4:30])        # split into slabs of 4
    ts.update(torch.from_numpy(movie[30:]))
    assert ts._chunk_len == 4
    mean, mx = ts.result()
    assert mx is None
    np.testing.assert_array_equal(
        mean, tsummary.movie_summary(torch.from_numpy(movie))[0].numpy())
    with pytest.raises(TypeError, match="folds"):
        ts.update(movie[:2].astype(np.float32))
    with pytest.raises(TypeError, match="StreamingSummary folds"):
        tsummary.StreamingSummary((2, 2), dtype=np.float64, device="cpu")


def test_streaming_summary_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsummary.StreamingSummary((4, 4), dtype=np.int16)


# --- streaming and tiled evaluate ---------------------------------------------

@pytest.fixture(scope="module")
def tiny_net():
    """nfb=4 weights in the JAX layout, drawn by the port from a seed."""
    return to_jax_params(UNet2DS(nfb=4, generator=torch.Generator().manual_seed(3)))


def _port_net(params, state):
    return from_jax_params(params, state).eval()


def _movie_from(source, movie, tmp_path):
    if source == "array":
        return movie, None
    path = str(tmp_path / "m.h5")
    with h5py.File(path, "w") as fp:
        fp.create_dataset("series/raw", data=movie)
    fp = h5py.File(path, "r")
    return fp["series/raw"], fp


@pytest.mark.parametrize("source", ["array", "h5py"])
def test_evaluate_movie_streaming_matches_jax(tiny_net, tmp_path, source):
    movie = np.random.default_rng(7).integers(0, 1500, (20, 48, 48)).astype(np.int16)
    src, fp = _movie_from(source, movie, tmp_path)
    try:
        mask, prob, mean = tev.evaluate_movie_streaming(
            _port_net(*tiny_net), src, window=WINDOW, chunk=7, device="cpu")
        jmask, jprob, jmean = jev.evaluate_movie_streaming(
            JAX_APPLY, *tiny_net, src, window=WINDOW, chunk=7, backend="host")
    finally:
        if fp is not None:
            fp.close()
    assert mask.dtype == np.uint8 and prob.dtype == np.float32
    np.testing.assert_allclose(mean, jmean, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(prob, jprob, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(mask, jmask)
    # The fold's mean is the one-call summary's, bit for bit.
    np.testing.assert_array_equal(
        mean, tsummary.movie_summary(torch.from_numpy(movie))[0].numpy())


@pytest.mark.parametrize("source", ["array", "h5py"])
@pytest.mark.parametrize("tta", [True, False])
def test_evaluate_movie_tiled_matches_jax(tiny_net, tmp_path, source, tta):
    """A 70x100 field of view, larger than the 48x48 window both ways."""
    movie = np.random.default_rng(2).integers(0, 1500, (9, 70, 100)).astype(np.int16)
    src, fp = _movie_from(source, movie, tmp_path)
    try:
        mask, prob, mean = tev.evaluate_movie_tiled(
            _port_net(*tiny_net), src, window=WINDOW, tta=tta, chunk=4,
            max_batch=5, device="cpu")
        jmask, jprob, jmean = jev.evaluate_movie_tiled(
            JAX_APPLY, *tiny_net, src, window=WINDOW, tta=tta, chunk=4,
            max_batch=5, backend="host")
    finally:
        if fp is not None:
            fp.close()
    assert mask.shape == prob.shape == mean.shape == (70, 100)
    np.testing.assert_allclose(mean, jmean, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(prob, jprob, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(mask, jmask)


SHAPES = [(48, 48), (40, 44), (70, 100), (96, 96), (97, 48), (200, 51)]
WINDOWS = [(48, 48), (32, 64)]
OVERLAPS = [None, 0, 8, 16, 31, 32, 48]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("overlap", OVERLAPS)
def test_tile_grid_matches_jax(window, overlap):
    for shape in SHAPES:
        try:
            want = jev.tile_grid(shape, window, overlap)
        except ValueError as e:
            with pytest.raises(ValueError, match="overlap must be"):
                tev.tile_grid(shape, window, overlap)
            assert "overlap must be" in str(e)
            continue
        assert tev.tile_grid(shape, window, overlap) == want


@pytest.mark.parametrize("tta", [True, False])
def test_predict_tiled_matches_jax(tiny_net, tta):
    rng = np.random.default_rng(4)
    img = rng.standard_normal((90, 61)).astype(np.float32)
    fwd = jtrainer.make_eval_forward(JAX_APPLY)
    want = jev.predict_tiled(fwd, *tiny_net, img, window=WINDOW, overlap=12,
                             max_batch=3, tta=tta)
    got = tev.predict_tiled(_port_net(*tiny_net), img, "cpu", window=WINDOW,
                            overlap=12, max_batch=3, tta=tta)
    assert got.shape == (90, 61) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_predict_tta_matches_jax(tiny_net):
    rng = np.random.default_rng(5)
    images = [rng.standard_normal(s).astype(np.float32)
              for s in ((48, 48), (40, 44), (33, 48))]
    fwd = jtrainer.make_eval_forward(JAX_APPLY)
    want = jev.predict_tta(fwd, *tiny_net, images, window=WINDOW, max_batch=5)
    got = tev.predict_tta(_port_net(*tiny_net), images, "cpu", window=WINDOW,
                          max_batch=5)
    for g, w, im in zip(got, want, images):
        assert g.shape == im.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)

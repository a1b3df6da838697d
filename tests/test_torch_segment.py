"""``segment_movie`` of the port against the JAX package's, on the CPU at
float32, with tiny nets (nfb=4): the golden transpose-mode checkpoint and an
upsampling-mode net with perturbed BN statistics.

Tolerance: the masks must be equal wherever the JAX probability, computed
once through ``unet2d.apply`` at HIGHEST precision on the same z-normalised,
padded frames, lies 1e-5 or more from the threshold. Nearer than that, the
two frameworks' float32 sums (taken in another order) may fall on either
side; such pixels are counted and must stay rare. bfloat16 is held against
float32 inside the port by the share of pixels that differ, not across
frameworks (bf16 rounds at other places in the two).
"""

import functools
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcalcium_tpu.models import movie_segmentation as jseg
from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_torch.models import movie_segmentation as tseg
from deepcalcium_torch.models.unet2d import UNet2DS, to_jax_params
from deepcalcium_torch.train.checkpoints import load_checkpoint

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HIGHEST = jax.lax.Precision.HIGHEST
BAND = 1e-5
APPLY = {
    "transpose": functools.partial(junet.apply, precision=HIGHEST),
    "upsampling": functools.partial(junet.apply, precision=HIGHEST,
                                    up_mode="upsampling"),
}


@pytest.fixture(scope="module")
def nets():
    """Both nets get head biases (0.05, -0.05): with the golden net's zero
    biases, a pixel whose head inputs are all ReLU zeros has a probability
    of exactly 0.5, and 2% of these pixels are such."""
    head_bias = np.array([0.05, -0.05], np.float32)
    params, state, _ = load_checkpoint(os.path.join(GOLD, "unet2d_tiny.ckpt"))
    params["head_conv"] = dict(params["head_conv"], bias=head_bias)
    out = {"transpose": (params, state)}
    # Upsampling mode: fresh weights, BN statistics and affine terms moved
    # off their initial 0/1 so that they matter.
    rng = np.random.default_rng(5)
    p, s = to_jax_params(UNet2DS(nfb=4, up_mode="upsampling",
                                 generator=torch.Generator().manual_seed(3)))
    for name in s:
        s[name] = {"mean": rng.normal(0, 0.2, s[name]["mean"].shape).astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, s[name]["var"].shape).astype(np.float32)}
        p[name] = {"gamma": rng.uniform(0.7, 1.3, p[name]["gamma"].shape).astype(np.float32),
                   "beta": rng.normal(0, 0.2, p[name]["beta"].shape).astype(np.float32)}
    # This net's median logit difference is about -0.6: centre it, so that
    # its masks hold both values.
    p["head_conv"]["bias"] = np.array([-0.3, 0.3], np.float32)
    out["upsampling"] = (p, s)
    return out


def make_movie(seed, shape, dtype):
    """Poisson background with bright flickering squares; uint16 movies
    reach past 32767 and float32 ones hold fractions."""
    rng = np.random.default_rng(seed)
    t, h, w = shape
    movie = rng.poisson(100, shape).astype(np.float64)
    for _ in range(4):
        cy, cx = rng.integers(4, h - 4), rng.integers(4, w - 4)
        on = rng.random(t) > 0.5
        movie[on, cy - 3:cy + 4, cx - 3:cx + 4] += 400
    if dtype == np.uint16:
        movie = movie * 100
    if dtype == np.float32:
        movie = movie + rng.random(shape)
    return movie.astype(dtype)


def jax_probs(params, state, movie, up_mode):
    """(T, H, W) probabilities of the straightforward composition: per-frame
    z-norm (population std plus 1e-6), reflect pad on the high sides to
    multiples of 16, ``unet2d.apply`` at HIGHEST, crop."""
    x = jnp.asarray(movie.astype(np.float32))
    mean = jnp.mean(x, axis=(1, 2), keepdims=True)
    std = jnp.std(x, axis=(1, 2), keepdims=True) + 1e-6
    x = (x - mean) / std
    h, w = x.shape[1:]
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    x = jnp.pad(x, ((0, 0), (0, hp - h), (0, wp - w)), mode="reflect")
    probs, _ = APPLY[up_mode](params, state, x, train=False)
    return np.asarray(probs[:, :h, :w])


def assert_masks_agree(got, want, probs, threshold, max_near=0.002):
    """Equal away from the threshold; returns the count of mismatches."""
    assert got.dtype == np.uint8 and got.shape == want.shape == probs.shape
    near = np.abs(probs - threshold) < BAND
    assert near.mean() <= max_near, f"{near.mean():.4%} of pixels in the band"
    np.testing.assert_array_equal(got[~near], want[~near])
    np.testing.assert_array_equal(got[~near], (probs > threshold)[~near])
    return int((got != want).sum())


CASES = [
    # up_mode, dtype, (T, H, W), slab: ragged T; H, W not multiples of 16
    ("transpose", np.int16, (11, 40, 44), 4),
    ("transpose", np.uint16, (9, 37, 50), 4),
    ("transpose", np.float32, (6, 32, 32), 4),
    ("upsampling", np.int16, (7, 35, 48), 3),
    ("upsampling", np.float32, (5, 33, 20), 8),
]


@pytest.mark.parametrize("up_mode,dtype,shape,slab", CASES)
def test_segment_movie_matches_jax(nets, up_mode, dtype, shape, slab):
    params, state = nets[up_mode]
    movie = make_movie(1, shape, dtype)
    probs = jax_probs(params, state, movie, up_mode)
    want = jseg.segment_movie(params, state, movie, slab=slab,
                              compute_dtype=jnp.float32,
                              apply_fn=APPLY[up_mode])
    got = tseg.segment_movie(params, state, movie, slab=slab,
                             compute_dtype=None, device="cpu")
    assert_masks_agree(got, want, probs, 0.5)
    assert 0 < got.mean() < 1, "an all-equal mask tests nothing"
    # The net's default dispatch in both packages (JAX: its lane-packed
    # forward for transpose mode, the plain one for upsampling mode).
    with jax.default_matmul_precision("highest"):
        want_default = jseg.segment_movie(params, state, movie, slab=slab,
                                          compute_dtype=jnp.float32)
    assert_masks_agree(got, want_default, probs, 0.5)


@pytest.mark.parametrize("threshold", [0.3, 0.7])
def test_segment_movie_other_thresholds(nets, threshold):
    params, state = nets["transpose"]
    movie = make_movie(2, (6, 40, 44), np.int16)
    probs = jax_probs(params, state, movie, "transpose")
    want = jseg.segment_movie(params, state, movie, slab=4,
                              threshold=threshold, compute_dtype=jnp.float32,
                              apply_fn=APPLY["transpose"])
    got = tseg.segment_movie(params, state, movie, slab=4, threshold=threshold,
                             compute_dtype=None, device="cpu")
    assert_masks_agree(got, want, probs, threshold)


def test_segment_movie_reads_an_h5py_dataset_lazily(nets, tmp_path):
    params, state = nets["transpose"]
    movie = make_movie(3, (10, 40, 44), np.int16)
    path = str(tmp_path / "movie.hdf5")
    with h5py.File(path, "w") as fp:
        fp.create_dataset("series/raw", data=movie)
    want = tseg.segment_movie(params, state, movie, slab=4,
                              compute_dtype=None, device="cpu")
    with h5py.File(path, "r") as fp:
        got = tseg.segment_movie(params, state, fp["series/raw"], slab=4,
                                 compute_dtype=None, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [">i2", np.float64, np.uint8])
def test_other_dtypes_are_cast_like_float32(nets, dtype):
    """A dtype PyTorch lacks (big-endian int16, as an HDF5 file may hold)
    is staged as float32; others are widened on the device. Both give the
    masks of the same values held as float32."""
    params, state = nets["transpose"]
    movie = (make_movie(8, (5, 32, 32), np.int16) // 4).astype(dtype)
    want = tseg.segment_movie(params, state, movie.astype(np.float32), slab=2,
                              compute_dtype=None, device="cpu")
    got = tseg.segment_movie(params, state, movie, slab=2,
                             compute_dtype=None, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slab", [1, 3, 64])
def test_tail_slab_runs_unpadded(nets, slab):
    """Any slab size gives the masks of one slab holding the whole movie
    (the JAX package pads the tail with zero frames instead): frames are
    independent in eval mode. Equal away from the threshold, since another
    batch size may sum in another order."""
    params, state = nets["transpose"]
    movie = make_movie(4, (7, 40, 44), np.int16)
    probs = jax_probs(params, state, movie, "transpose")
    whole = tseg.segment_movie(params, state, movie, slab=7,
                               compute_dtype=None, device="cpu")
    got = tseg.segment_movie(params, state, movie, slab=slab,
                             compute_dtype=None, device="cpu")
    assert_masks_agree(got, whole, probs, 0.5)


def test_bfloat16_close_to_float32_inside_the_port(nets):
    """The default compute dtype: bf16 convs move a probability by up to
    about 1e-2, so only pixels that near the threshold may flip."""
    params, state = nets["transpose"]
    movie = make_movie(5, (6, 48, 48), np.int16)
    probs = jax_probs(params, state, movie, "transpose")
    f32 = tseg.segment_movie(params, state, movie, slab=4, compute_dtype=None,
                             device="cpu")
    bf16 = tseg.segment_movie(params, state, movie, slab=4, device="cpu")
    differ = f32 != bf16
    assert differ.mean() < 0.02
    assert not (differ & (np.abs(probs - 0.5) > 0.05)).any()


def test_apply_fn_takes_precedence_and_threshold_is_strict():
    movie = make_movie(6, (5, 20, 24), np.int16)
    seen = []

    def apply_fn(x):
        seen.append(tuple(x.shape))
        assert x.dtype == torch.float32
        # Per-frame z-norm: mean 0 and population std 1 over the true frame.
        true = x[:, :20, :24]
        torch.testing.assert_close(true.mean(dim=(1, 2)),
                                   torch.zeros(len(x)), atol=1e-5, rtol=0)
        torch.testing.assert_close(true.std(dim=(1, 2), correction=0),
                                   torch.ones(len(x)), atol=1e-4, rtol=0)
        # The pad reflects on the high sides only.
        torch.testing.assert_close(x[:, 20:, :24], true[:, 7:19].flip(1))
        torch.testing.assert_close(x[:, :20, 24:], true[:, :, 15:23].flip(2))
        out = torch.full_like(x, 0.5)
        out[:, ::2] = 0.5 + 1e-6
        return out

    got = tseg.segment_movie(None, None, movie, slab=2, apply_fn=apply_fn,
                             device="cpu")
    assert seen == [(2, 32, 32), (2, 32, 32), (1, 32, 32)]
    assert got.shape == movie.shape
    assert got[:, ::2].all() and not got[:, 1::2].any()


def test_segment_movie_guards(nets):
    params, state = nets["transpose"]
    movie = make_movie(7, (3, 32, 32), np.int16)
    with pytest.raises(TypeError, match="Mesh"):
        tseg.segment_movie(params, state, movie, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="slab"):
        tseg.segment_movie(params, state, movie, slab=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tseg.segment_movie(params, state, movie)


def test_producer_errors_surface(nets):
    """A read that fails on the prefetch thread raises in the caller."""
    params, state = nets["transpose"]

    class Broken:
        shape, dtype = (6, 32, 32), np.dtype(np.int16)

        def __getitem__(self, key):
            if key.start >= 4:
                raise OSError("disk gone")
            return np.zeros((key.stop - key.start, 32, 32), np.int16)

    with pytest.raises(OSError, match="disk gone"):
        tseg.segment_movie(params, state, Broken(), slab=2, compute_dtype=None,
                           device="cpu")

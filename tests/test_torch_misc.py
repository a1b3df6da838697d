"""The small host functions the port copies from the JAX package, each held
equal to its original on the same inputs: ``utils/model_downloads.py``,
``Region`` / ``regions_to_mask`` / ``match_centers``, the D4 helpers
(``apply_d4``, ``apply_d4_batch``, ``tta_expand_np``, ``tta_collapse_np``),
``utils/config.py``, ``utils/profiling.py::annotate``,
``utils/visualization.py::dataset_to_mp4``, ``unet2d.param_count`` and
``data/fixtures.py``. Everything here is integer or copied float
arithmetic, so every comparison is exact.
"""

import inspect
import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu.data import fixtures as jfix
from deepcalcium_tpu.metrics import neurofinder as jnf
from deepcalcium_tpu.models import unet2d as junet
from deepcalcium_tpu.ops import augment as jaug
from deepcalcium_tpu.utils import config as jconfig
from deepcalcium_tpu.utils import model_downloads as jdl
from deepcalcium_tpu.utils import visualization as jvis
from deepcalcium_torch.data import fixtures as tfix
from deepcalcium_torch.metrics import neurofinder as tnf
from deepcalcium_torch.models import unet2d as tunet
from deepcalcium_torch.ops import augment as taug
from deepcalcium_torch.utils import config as tconfig
from deepcalcium_torch.utils import model_downloads as tdl
from deepcalcium_torch.utils import profiling as tprof
from deepcalcium_torch.utils import visualization as tvis

torch.set_num_threads(1)


# --- utils/model_downloads.py ------------------------------------------------

def test_model_urls_equal():
    assert tdl.UNET2DS_MODEL_URL == jdl.UNET2DS_MODEL_URL
    assert tdl.UNET1D_MODEL_URL == jdl.UNET1D_MODEL_URL


@pytest.mark.parametrize("mod", [jdl, tdl], ids=["jax", "port"])
def test_download_model_is_idempotent_and_atomic(mod, tmp_path, monkeypatch):
    """A local ``file://`` URL stands in for the release server."""
    src = tmp_path / "weights.bin"
    src.write_bytes(b"weights" * 100)
    dst = str(tmp_path / "sub" / "model.hdf5")
    assert mod.download_model(src.as_uri(), dst) == dst
    assert open(dst, "rb").read() == src.read_bytes()
    assert not os.path.exists(dst + ".tmp")
    # A second call downloads nothing: the URL need not even resolve.
    assert mod.download_model("file:///no/such/file", dst) == dst

    # A failed download leaves nothing at the destination.
    def broken(url, tmp):
        open(tmp, "wb").write(b"partial")
        raise OSError("connection lost")

    monkeypatch.setattr(mod.request, "urlretrieve", broken)
    other = str(tmp_path / "other.hdf5")
    with pytest.raises(OSError, match="connection lost"):
        mod.download_model("file:///x", other)
    assert not os.path.exists(other)


# --- metrics/neurofinder.py --------------------------------------------------

def _masks(seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((40, 44)) < 0.08).astype(np.uint8)
    b = np.roll(a, 1, axis=1) | (rng.random((40, 44)) < 0.01)
    return a, b.astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_region_helpers_match_jax(seed):
    a, b = _masks(seed)
    ja, jb = jnf.mask_to_regions(a), jnf.mask_to_regions(b)
    ta, tb = tnf.mask_to_regions(a), tnf.mask_to_regions(b)
    # Region: the same coordinates, center and length.
    regions = [tnf.Region(c) for c in ta]
    for r, jr in zip(regions, ja):
        np.testing.assert_array_equal(r.coordinates, jr.coordinates)
        np.testing.assert_array_equal(r.center, jr.center)
        assert len(r) == len(jr) and r.coordinates.dtype == np.int64
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        tnf.Region(np.zeros((3, 3)))
    # regions_to_mask inverts mask_to_regions, from arrays or Regions.
    for regs in (ta, regions):
        m = tnf.regions_to_mask(regs, a.shape)
        assert m.dtype == np.uint8
        np.testing.assert_array_equal(m, jnf.regions_to_mask(ja, a.shape))
        np.testing.assert_array_equal(m, a)
    # match_centers, bounded and unbounded, from arrays or Regions.
    for threshold in (np.inf, 3.0, 0.5):
        want = jnf.match_centers(ja, jb, threshold)
        assert tnf.match_centers(ta, tb, threshold) == want
        assert tnf.match_centers(regions, [tnf.Region(c) for c in tb],
                                 threshold) == want
    assert tnf.match_centers(ta, []) == jnf.match_centers(ja, []) \
        == [None] * len(ta)
    # The scores built on them are unchanged.
    assert tnf.nf_mask_metrics(a, b) == jnf.nf_mask_metrics(a, b)
    assert tnf.shapes(regions, tb) == jnf.shapes(ja, jb)


# --- ops/augment.py ----------------------------------------------------------

def test_d4_helpers_match_jax():
    rng = np.random.default_rng(0)
    batch = rng.standard_normal((8, 6, 6)).astype(np.float32)
    codes = np.arange(8, dtype=np.int32)
    want = np.asarray(jaug.apply_d4_batch(batch, codes))
    got = taug.apply_d4_batch(torch.from_numpy(batch), codes)
    np.testing.assert_array_equal(got.numpy(), want)
    for code in range(8):
        np.testing.assert_array_equal(
            taug.apply_d4(torch.from_numpy(batch[0]), code).numpy(),
            np.asarray(jaug.apply_d4(batch[0], code)))
    views = taug.tta_expand_np(batch)
    np.testing.assert_array_equal(views, jaug.tta_expand_np(batch))
    np.testing.assert_array_equal(views,
                                  taug.tta_expand(torch.from_numpy(batch)).numpy())
    preds = rng.random((8, 3, 6, 6)).astype(np.float32)
    np.testing.assert_array_equal(taug.tta_collapse_np(preds),
                                  jaug.tta_collapse_np(preds))
    # Collapse inverts expand, up to the rounding of a float32 mean of 8.
    np.testing.assert_allclose(taug.tta_collapse_np(views), batch, rtol=1e-6,
                               atol=1e-7)
    assert taug.__all__ == [n for n in jaug.__all__ if n in taug.__all__]
    assert set(jaug.__all__) == set(taug.__all__)


# --- utils/config.py ---------------------------------------------------------

def test_config_shared_with_jax(tmp_path, monkeypatch):
    """One env var, one JSON file: each package reads what the other
    wrote."""
    for first, second, tag in ((tconfig, jconfig, "t"), (jconfig, tconfig, "j")):
        root = tmp_path / tag
        monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(root))
        assert first.base_dir() == second.base_dir() == str(root)
        assert first.config_path() == second.config_path() \
            == str(root / "deep-calcium-tpu.json")
        cfg = first.get_config()
        assert cfg == {"datasets_dir": str(root / "datasets"),
                       "checkpoints_dir": str(root / "checkpoints")}
        assert os.path.isdir(cfg["datasets_dir"])
        assert json.load(open(first.config_path())) == cfg
        assert second.get_config() == cfg
        assert second.datasets_dir() == first.datasets_dir()
        assert second.checkpoints_dir() == first.checkpoints_dir()
    monkeypatch.delenv("DEEPCALCIUM_TPU_DIR")
    assert tconfig.base_dir() == jconfig.base_dir()
    # A corrupt file: the same error.
    monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(tmp_path / "bad"))
    os.makedirs(tmp_path / "bad")
    (tmp_path / "bad" / "deep-calcium-tpu.json").write_text("{")
    for mod in (tconfig, jconfig):
        with pytest.raises(RuntimeError, match="is corrupt"):
            mod.get_config()


# --- utils/profiling.py ------------------------------------------------------

def test_annotate_names_a_span_in_a_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.annotate("stencil-span"):
            torch.ones(4).sum()
    assert any(e.key == "stencil-span" for e in prof.key_averages())
    # Outside a trace it is a no-op that still runs its block.
    with tprof.annotate("idle"):
        pass


# --- utils/visualization.py --------------------------------------------------

def _movie_and_masks():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 900, (230, 20, 24)).astype(np.int16)
    m = np.zeros((2, 20, 24), np.int8)
    m[0, 3:9, 3:9] = 1
    m[1, 10:17, 12:20] = 1
    return s, m


def test_dataset_to_mp4_png_fallback_matches_jax(tmp_path, monkeypatch):
    """Without a video writer both packages write PNG frames: the same
    files with the same pixels."""
    import sys

    from PIL import Image

    monkeypatch.setitem(sys.modules, "imageio.v2", None)  # import fails
    s, m = _movie_and_masks()
    jvis.dataset_to_mp4(s, m, str(tmp_path / "j.mp4"))
    tvis.dataset_to_mp4(s, m, str(tmp_path / "t.mp4"))
    jframes = sorted(os.listdir(tmp_path / "j.mp4.frames"))
    tframes = sorted(os.listdir(tmp_path / "t.mp4.frames"))
    assert tframes == jframes and len(tframes) == 115
    for name in tframes[::23]:
        a = np.asarray(Image.open(tmp_path / "t.mp4.frames" / name))
        b = np.asarray(Image.open(tmp_path / "j.mp4.frames" / name))
        assert a.shape == (20, 24, 3)
        np.testing.assert_array_equal(a, b)
        assert (a[3, 3] == [102, 255, 255]).all()  # a cyan outline pixel
    # Without masks: grayscale frames.
    tvis.dataset_to_mp4(s[:3], None, str(tmp_path / "plain.mp4"))
    a = np.asarray(Image.open(tmp_path / "plain.mp4.frames" / "frame_000000.png"))
    assert (a[..., 0] == a[..., 1]).all() and (a[..., 1] == a[..., 2]).all()


def test_dataset_to_mp4_writer_matches_jax(tmp_path):
    """With imageio installed both packages write the same file (an mp4
    where the codec is present, else a GIF)."""
    pytest.importorskip("imageio.v2")
    s, m = _movie_and_masks()
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jvis.dataset_to_mp4(s[:20], m, str(tmp_path / "j" / "movie.mp4"))
    tvis.dataset_to_mp4(s[:20], m, str(tmp_path / "t" / "movie.mp4"))
    names = os.listdir(tmp_path / "t")
    assert names == os.listdir(tmp_path / "j") and len(names) == 1
    assert names[0] in ("movie.mp4", "movie.gif")
    assert (tmp_path / "t" / names[0]).read_bytes() \
        == (tmp_path / "j" / names[0]).read_bytes()


# --- models/unet2d.py --------------------------------------------------------

@pytest.mark.parametrize("nfb,up_mode", [(4, "transpose"), (8, "upsampling")])
def test_param_count_matches_jax(nfb, up_mode):
    model = tunet.UNet2DS(nfb=nfb, up_mode=up_mode)
    params, _ = tunet.to_jax_params(model)
    assert tunet.param_count(model) == junet.param_count(params)


# --- data/fixtures.py --------------------------------------------------------

def _h5_tree(path):
    out = {}
    with h5py.File(path, "r") as fp:
        out["attrs"] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                        for k, v in fp.attrs.items()}
        fp.visititems(lambda name, obj: out.__setitem__(
            name, (obj.dtype, obj[...]) if isinstance(obj, h5py.Dataset)
            else {k: np.asarray(v).tolist() for k, v in obj.attrs.items()}))
    return out


def _assert_h5_equal(a, b):
    ta, tb = _h5_tree(a), _h5_tree(b)
    assert sorted(ta) == sorted(tb)
    for key in ta:
        if isinstance(ta[key], tuple):
            assert ta[key][0] == tb[key][0], key
            np.testing.assert_array_equal(ta[key][1], tb[key][1], err_msg=key)
        else:
            assert ta[key] == tb[key], key


def test_fixture_generators_match_jax(tmp_path):
    assert tfix.__all__[:4] == jfix.__all__
    for name in tfix.__all__:
        assert (inspect.signature(getattr(tfix, name))
                == inspect.signature(getattr(jfix, name))), name
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    mj, cj = jfix.synthetic_neurons(rng_j, (40, 44), 5)
    mt, ct = tfix.synthetic_neurons(rng_t, (40, 44), 5)
    np.testing.assert_array_equal(mt, mj)
    assert ct == cj
    rj = jfix.realistic_neurons(rng_j, (64, 64), 12)
    rt = tfix.realistic_neurons(rng_t, (64, 64), 12)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(tfix.realistic_movie(rng_t, rt, 9),
                                  jfix.realistic_movie(rng_j, rj, 9))


@pytest.mark.parametrize("maker,kw", [
    ("make_neurons_hdf5", dict(name="fx.00.00", shape=(32, 36), nb_frames=7,
                               nb_neurons=3, seed=2)),
    ("make_realistic_hdf5", dict(name="fx.01.00", shape=(48, 48), nb_frames=6,
                                 nb_neurons=8, seed=3)),
    ("make_spikes_hdf5", dict(name="fx.spikes", nb_traces=4, trace_len=128,
                              seed=5)),
])
def test_fixture_files_match_jax(maker, kw, tmp_path):
    a = getattr(jfix, maker)(str(tmp_path / "j" / "d.hdf5"), **kw)
    b = getattr(tfix, maker)(str(tmp_path / "t" / "d.hdf5"), **kw)
    _assert_h5_equal(a, b)


def test_fixture_tiff_tree_matches_jax(tmp_path):
    from PIL import Image

    dj, movie_j, masks_j = jfix.make_tiff_tree(str(tmp_path / "j"), seed=1)
    dt, movie_t, masks_t = tfix.make_tiff_tree(str(tmp_path / "t"), seed=1)
    np.testing.assert_array_equal(movie_t, movie_j)
    np.testing.assert_array_equal(masks_t, masks_j)
    names = sorted(os.listdir(os.path.join(dj, "images")))
    assert sorted(os.listdir(os.path.join(dt, "images"))) == names
    for n in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(dt, "images", n))),
            np.asarray(Image.open(os.path.join(dj, "images", n))))
    assert json.load(open(os.path.join(dt, "regions", "regions.json"))) \
        == json.load(open(os.path.join(dj, "regions", "regions.json")))
    dtest, _, _ = tfix.make_tiff_tree(str(tmp_path / "t"), name="x.test",
                                      test_set=True)
    assert not os.path.exists(os.path.join(dtest, "regions"))


def test_fixture_keras_checkpoint_matches_jax(tmp_path):
    a = jfix.make_keras_unet2ds_hdf5(str(tmp_path / "j.hdf5"), nfb=4, seed=3)
    b = tfix.make_keras_unet2ds_hdf5(str(tmp_path / "t.hdf5"), nfb=4, seed=3)
    _assert_h5_equal(a, b)

"""The port's ingest (TIFF tree -> contract HDF5), custom datasets, native
TIFF decoder and the host utilities they use, against the JAX package's, on
the CPU (the summaries fold with the plain fold, ``device="cpu"``).

Everything written must be equal: raw frames, the float16 mean (both
packages' float32 means are exact here: sums of a few frames below 2**24,
one IEEE division), max and masks. One deliberate difference is pinned: a
floating-point TIFF frame decoded by PIL is clamped to int16, NaN -> 0, as
the native decoder does; the JAX package's PIL path casts it, and values
past the range wrap.
"""

import json
import logging
import os

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from deepcalcium_tpu.data import _ingest as j_ingest
from deepcalcium_tpu.data import custom as jcustom
from deepcalcium_tpu.data import nf as jnf
from deepcalcium_tpu.data import tiff_native as jtiff
from deepcalcium_tpu.data.fixtures import make_tiff_tree
from deepcalcium_tpu.metrics import neurofinder as jmetrics
from deepcalcium_tpu.utils import config as jconfig
from deepcalcium_tpu.utils import visualization as jvis
from deepcalcium_torch.data import _ingest as t_ingest
from deepcalcium_torch.data import custom as tcustom
from deepcalcium_torch.data import nf as tnf
from deepcalcium_torch.data import tiff_native as ttiff
from deepcalcium_torch.metrics import neurofinder as tmetrics
from deepcalcium_torch.utils import config as tconfig
from deepcalcium_torch.utils import profiling as tprofiling
from deepcalcium_torch.utils import runtime as truntime
from deepcalcium_torch.utils import visualization as tvis

torch.set_num_threads(1)

CONTRACT = ["series/raw", "series/mean", "series/max", "masks/raw", "masks/max"]


def _read(path):
    with h5py.File(path, "r") as fp:
        name = fp.attrs["name"]
        return name, {k: fp[k][...] for k in CONTRACT if k in fp}


def _assert_same_file(got, want):
    (gname, g), (wname, w) = _read(got), _read(want)
    assert gname == wname
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("test_set", [False, True])
def test_ingest_matches_jax(tmp_path, test_set):
    name = "synthetic.01.00" + (".test" if test_set else "")
    ds_dir, movie, masks = make_tiff_tree(str(tmp_path), name, shape=(48, 48),
                                          nb_frames=12, test_set=test_set)
    got = tnf.ingest_tiff_dataset(ds_dir, str(tmp_path / "t.hdf5"), name,
                                  chunk=5, device="cpu")
    want = jnf.ingest_tiff_dataset(ds_dir, str(tmp_path / "j.hdf5"), name,
                                   chunk=5)
    _assert_same_file(got, want)
    _, g = _read(got)
    np.testing.assert_array_equal(g["series/raw"], movie)
    assert ("masks/raw" in g) is not test_set
    assert not os.path.exists(got + ".tmp")


def test_ingest_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    ds_dir, _, _ = make_tiff_tree(str(tmp_path), "x.00", nb_frames=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnf.ingest_tiff_dataset(ds_dir, str(tmp_path / "x.hdf5"), "x.00")
    assert not os.path.exists(tmp_path / "x.hdf5.tmp")


def test_nf_load_hdf5_ingests_a_downloaded_tree_once(tmp_path):
    """With the archive already unpacked, nothing is fetched: the tree is
    ingested, and a second call returns the same file untouched."""
    ddir = tmp_path / "nf"
    make_tiff_tree(str(ddir), "neurofinder.00.00", nb_frames=4)
    paths = tnf.nf_load_hdf5("neurofinder.00.00", datasets_dir_override=str(ddir),
                             device="cpu")
    assert paths == [str(ddir / "neurofinder.00.00" / "dataset.hdf5")]
    mtime = os.path.getmtime(paths[0])
    assert tnf.nf_load_hdf5(["neurofinder.00.00"], str(ddir), device="cpu") == paths
    assert os.path.getmtime(paths[0]) == mtime


@pytest.mark.parametrize("names", ["all", "ALL_train", "all_test",
                                   "neurofinder.00.00,neurofinder.01.00",
                                   ["a", "b"], ("neurofinder.02.00",)])
def test_resolve_names_matches_jax(names):
    assert tnf._resolve_names(names) == jnf._resolve_names(names)
    assert tnf.NEUROFINDER_NAMES == jnf.NEUROFINDER_NAMES
    assert tnf.NAME_TO_URL == jnf.NAME_TO_URL


def test_pil_path_zero_fills_a_bad_frame_as_jax(tmp_path, monkeypatch):
    root, movie, _ = make_tiff_tree(str(tmp_path), "bad.00.00", shape=(24, 24),
                                    nb_frames=6)
    Image.fromarray(np.zeros((10, 10), np.int32), mode="I").save(
        os.path.join(root, "images", "image00003.tiff"))
    monkeypatch.setattr(jtiff, "available", lambda: False)
    monkeypatch.setattr(ttiff, "available", lambda: False)
    got = tnf.ingest_tiff_dataset(root, str(tmp_path / "t.hdf5"), "bad.00.00",
                                  device="cpu")
    want = jnf.ingest_tiff_dataset(root, str(tmp_path / "j.hdf5"), "bad.00.00")
    _assert_same_file(got, want)
    raw = _read(got)[1]["series/raw"]
    assert raw[3].sum() == 0 and raw[2].sum() > 0


def test_native_decode_equals_pil(tmp_path):
    ds_dir, movie, _ = make_tiff_tree(str(tmp_path), "nat.00", shape=(64, 40),
                                      nb_frames=9, test_set=True)
    img_dir = os.path.join(ds_dir, "images")
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    assert ttiff.available()
    frames, status = ttiff.decode_batch(paths, 64, 40)
    assert status.sum() == 0
    np.testing.assert_array_equal(frames, movie)
    np.testing.assert_array_equal(
        frames, np.stack([t_ingest.read_tiff(p) for p in paths]).astype(np.int16))
    assert ttiff.tiff_size(paths[0]) == (64, 40)
    assert ttiff.tiff_size(str(tmp_path / "missing.tiff")) is None
    bad = str(tmp_path / "bad.tiff")
    with open(bad, "wb") as fp:
        fp.write(b"II*\x00junkjunk")
    frames, status = ttiff.decode_batch([paths[0], bad, paths[1]], 64, 40)
    np.testing.assert_array_equal(status, [0, 1, 0])
    assert frames[1].sum() == 0
    # The built library lives under build/, named by the source's hash.
    assert ttiff._build().parent == ttiff.BUILD_DIR


def test_decode_chunk_retries_flagged_frames_on_pil(tmp_path, monkeypatch):
    ds_dir, movie, _ = make_tiff_tree(str(tmp_path), "nat.01", shape=(32, 32),
                                      nb_frames=3, test_set=True)
    img_dir = os.path.join(ds_dir, "images")
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    real = ttiff.decode_batch

    def flaky(ps, h, w, nthreads=None):
        frames, status = real(ps, h, w, nthreads)
        frames[1], status[1] = 0, 1
        return frames, status

    monkeypatch.setattr(ttiff, "decode_batch", flaky)
    np.testing.assert_array_equal(t_ingest.decode_chunk(paths, (32, 32)), movie)


def test_float_tiff_is_clamped_where_jax_wraps(tmp_path, monkeypatch):
    """A float32 frame with values past the int16 range and a NaN: the port
    clamps on the PIL path as the native decoder does; the JAX package's
    PIL path does not clamp."""
    frame = np.array([[40000.0, -40000.0, np.nan, 123.7],
                      [-5.5, 32767.0, -32768.0, 1e9]], np.float32)
    path = str(tmp_path / "f.tiff")
    Image.fromarray(frame, mode="F").save(path)
    clamped = np.array([[32767, -32768, 0, 123],
                        [-5, 32767, -32768, 32767]], np.int16)
    monkeypatch.setattr(ttiff, "available", lambda: False)
    monkeypatch.setattr(jtiff, "available", lambda: False)
    np.testing.assert_array_equal(t_ingest.decode_chunk([path], (2, 4))[0], clamped)
    with np.errstate(invalid="ignore"):
        jax_frame = j_ingest.decode_chunk([path], (2, 4))[0]
    assert not np.array_equal(jax_frame, clamped)
    monkeypatch.undo()
    assert ttiff.available()
    frames, status = ttiff.decode_batch([path], 2, 4)  # the native decoder
    assert status[0] == 0
    np.testing.assert_array_equal(frames[0], clamped)


def test_bbox_masks_match_jax():
    centers = [(10, 10), (2, 30), (39, 1), (20, 38)]
    got = tcustom.bbox_masks(centers, radius=3, shape=(40, 40))
    np.testing.assert_array_equal(got, jcustom.bbox_masks(centers, 3, (40, 40)))
    assert got.dtype == np.int8 and got[0].sum() == 36 and got[1].sum() == 30


@pytest.mark.parametrize("annotation", ["centers", "masks", "none"])
def test_make_dataset_from_tiffs_matches_jax(tmp_path, annotation):
    ds_dir, movie, masks = make_tiff_tree(str(tmp_path), "custom.00",
                                          shape=(32, 32), nb_frames=8,
                                          test_set=True)
    kw = {"centers": dict(centers=[(8, 8), (24, 24)], radius=2),
          "masks": dict(masks=np.stack([np.eye(32, dtype=np.int8)] * 2)),
          "none": {}}[annotation]
    glob_ = os.path.join(ds_dir, "images", "*.tiff")
    got = tcustom.make_dataset_from_tiffs("custom.00", glob_,
                                          str(tmp_path / "t.hdf5"), chunk=3,
                                          device="cpu", **kw)
    want = jcustom.make_dataset_from_tiffs("custom.00", glob_,
                                           str(tmp_path / "j.hdf5"), chunk=3, **kw)
    _assert_same_file(got, want)
    mtime = os.path.getmtime(got)
    tcustom.make_dataset_from_tiffs("custom.00", "ignored", got)  # idempotent
    assert os.path.getmtime(got) == mtime


def test_make_dataset_from_tiffs_zero_fills_corrupt_frames(tmp_path):
    ds_dir, movie, _ = make_tiff_tree(str(tmp_path), "corrupt.00", shape=(32, 32),
                                      nb_frames=6, test_set=True)
    victim = sorted(os.listdir(os.path.join(ds_dir, "images")))[2]
    with open(os.path.join(ds_dir, "images", victim), "wb") as fp:
        fp.write(b"II*\x00garbage")
    out = tcustom.make_dataset_from_tiffs(
        "corrupt.00", os.path.join(ds_dir, "images", "*.tiff"),
        str(tmp_path / "c.hdf5"), device="cpu")
    raw = _read(out)[1]["series/raw"]
    assert raw[2].sum() == 0
    np.testing.assert_array_equal(raw[3], movie[3])
    with pytest.raises(ValueError, match="radius"):
        tcustom.make_dataset_from_tiffs("x", "nothing", str(tmp_path / "x.h5"),
                                        centers=[(1, 1)], device="cpu")


# --- host utilities -----------------------------------------------------------

def test_label_mask_and_outlines_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.random((40, 36)).astype(np.float32)
    m = (rng.random((40, 36)) > 0.8).astype(np.uint8)
    m2 = np.zeros_like(m)
    m2[10:20, 5:15] = 1
    np.testing.assert_array_equal(tmetrics.label_mask(m), jmetrics.label_mask(m))
    for masks, colors in (([m], ["red"]), ([m2, m], ["blue", "cyan"]),
                          ([np.zeros_like(m)], ["green"])):
        np.testing.assert_array_equal(tvis.mask_outlines(img, masks, colors),
                                      jvis.mask_outlines(img, masks, colors))
    with pytest.raises(ValueError, match="one colour per mask"):
        tvis.mask_outlines(img, [m], [])
    out = tvis.mask_outlines(img, [m2], ["red"])
    tvis.save_png(str(tmp_path / "o.png"), out)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.png")), out)


def test_runtime_profiling_and_config(caplog):
    def some_function():
        return truntime.funcname()

    assert some_function() == "some_function"
    with caplog.at_level(logging.INFO):
        with truntime.phase_timer("phase_x", items=10, unit="views"):
            pass
        with truntime.phase_timer("phase_y"):
            pass
    assert "phase_x:" in caplog.text and "views/s" in caplog.text
    assert "phase_y:" in caplog.text
    meter = tprofiling.ThroughputMeter()
    for _ in range(3):
        with meter.track("decode", 4):
            pass
    assert set(meter.rates()) == {"decode"} and meter.rates()["decode"] > 0
    assert tconfig.datasets_dir() == jconfig.datasets_dir()
    assert os.path.isdir(tconfig.datasets_dir())
    with open(jconfig.config_path()) as fp:
        assert json.load(fp)["datasets_dir"] == tconfig.datasets_dir()

"""The port's example scripts (``examples_torch/``) against the JAX
package's (``examples/``), on the CPU (``--device cpu``), on the same fixture
files and the same checkpoint.

Nets are nfb=4 with head biases and non-trivial BN statistics (a net with
zero head biases puts dead-ReLU pixels at exactly 0.5), windows are 48x48 or
smaller, and one checkpoint, written by the port and read by both packages,
serves the module.

Tolerances, each stated again where it is used: argv lists, parsed Matlab
centres, ingested datasets, submission JSONs, sampled configs, fixture files,
printed tables and report files are equal; ``scaled_summary_func`` within
1e-6 absolute; activation-map pixels within 1/255 (one grey level: the maps
are float32 sums taken in another order, scaled to 0..255 and truncated).
"""

import csv
import json
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import scipy.io
import torch

from deepcalcium_tpu import cli as jcli
from deepcalcium_tpu.data import fixtures as jfixtures
from deepcalcium_tpu.data.nf import nf_submit as jnf_submit
from deepcalcium_tpu.models import unet_2d_summary as jsummary
from deepcalcium_torch import cli as tcli
from deepcalcium_torch.data import fixtures as tfixtures
from deepcalcium_torch.data.nf import nf_submit as tnf_submit
from deepcalcium_torch.models import unet_2d_summary as tsummary
from deepcalcium_torch.models.unet2d import UNet2DS, to_jax_params
from deepcalcium_torch.train import checkpoints as tckpt
from examples.analysis import activation_maps as jmaps
from examples.analysis import dataset_stats as jstats
from examples.analysis import hyperparam_marginals
from examples.analysis import spike_stats as jspikes
from examples.neurons import unet2ds_hyperparam_search as jsearch
from examples.neurons import unet2ds_sj as jsj
from examples_torch.analysis import activation_maps as tmaps
from examples_torch.analysis import dataset_stats as tstats
from examples_torch.analysis import spike_stats as tspikes
from examples_torch.neurons import nf_videos as tvideos
from examples_torch.neurons import unet2ds_hyperparam_search as tsearch
from examples_torch.neurons import unet2ds_nf as tnf
from examples_torch.neurons import unet2ds_sj as tsj
from examples_torch.spikes import unet1d_spikes as tspk

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_jax_script(monkeypatch, relpath, argv, main=None):
    """Run a JAX example as ``python <relpath> <argv>`` would: its ``main``
    reads ``sys.argv``, or the file runs as ``__main__``."""
    monkeypatch.setattr(sys, "argv", [relpath] + list(argv))
    with jax.default_matmul_precision("highest"):
        if main is not None:
            return main()
        import runpy

        return runpy.run_path(os.path.join(REPO, relpath), run_name="__main__")


@pytest.fixture
def dcdir(tmp_path, monkeypatch):
    """A fresh data directory for both packages (they share the variable)."""
    monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(tmp_path / "dc"))
    return tmp_path / "dc"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(path, params, state) of an nfb=4 net with head biases."""
    params, state = to_jax_params(
        UNet2DS(nfb=4, generator=torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(1)
    for name in params:
        if name.endswith("_bn"):
            c = params[name]["gamma"].shape
            params[name] = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "beta": rng.normal(0, 0.2, c).astype(np.float32)}
            state[name] = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
                           "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        else:
            params[name]["bias"] = rng.normal(
                0, 0.1, params[name]["bias"].shape).astype(np.float32)
    path = tckpt.save_checkpoint(
        str(tmp_path_factory.mktemp("ckpt") / "nfb4.ckpt"), params, state)
    return path, params, state


# --- 1, 2: the two shims ----------------------------------------------------

def test_unet2ds_nf_is_the_command_line():
    assert tnf.main is tcli.main


@pytest.mark.parametrize("argv", [
    ["train", "a.hdf5", "b.hdf5", "-e", "3"],
    ["crossval", "a.hdf5"],
    ["predict", "a.hdf5", "-m", "best.ckpt", "--arch", "glm"],
    [],
    ["evaluate", "a.hdf5"],
])
def test_unet1d_spikes_hands_cli_the_same_argv(argv, monkeypatch, capsys):
    """Both shims translate train / crossval / predict the same way and
    print their usage for anything else."""
    calls = {"j": [], "t": []}
    monkeypatch.setattr(jcli, "main", calls["j"].append)
    monkeypatch.setattr(tcli, "main", calls["t"].append)
    _run_jax_script(monkeypatch, "examples/spikes/unet1d_spikes.py", argv)
    jout = capsys.readouterr().out
    tspk.main(argv)
    tout = capsys.readouterr().out
    assert calls["t"] == calls["j"]
    if argv and argv[0] in ("train", "crossval", "predict"):
        assert len(calls["t"]) == 1 and calls["t"][0][1:] != argv
        assert calls["t"][0][0] in ("spikes-train", "spikes-predict")
        assert jout == tout == ""
    else:
        assert calls["t"] == []
        assert "unet1d_spikes.py train data1.hdf5" in tout
        assert "unet1d_spikes.py train data1.hdf5" in jout
    # argv=None reads sys.argv, as running the file does.
    calls["t"].clear()
    monkeypatch.setattr(sys, "argv", ["unet1d_spikes.py"] + argv)
    tspk.main()
    assert calls["t"] == calls["j"]


# --- 3: nf_videos -----------------------------------------------------------

@pytest.mark.parametrize("ingested", [True, False],
                         ids=["ingested", "tiff_tree"])
def test_nf_videos_writes_the_same_files(ingested, dcdir, tmp_path,
                                         monkeypatch):
    """On a dataset file that exists, and on a TIFF tree that each script
    ingests first (the port with ``--device cpu``: its summaries fold there).
    Each script gets a data directory of its own in the second case."""
    outs = {"j": tmp_path / "vj", "t": tmp_path / "vt"}
    for d in outs.values():
        d.mkdir()
    roots = {"j": dcdir, "t": dcdir}
    if ingested:
        ds = jfixtures.make_neurons_hdf5(
            str(dcdir / "datasets" / "neurons_nf" / "vid.00.00"
                / "dataset.hdf5"),
            name="vid.00.00", shape=(32, 32), nb_frames=6)
        assert os.path.exists(ds)
    else:
        roots = {"j": tmp_path / "dcj", "t": tmp_path / "dct"}
        for r in roots.values():
            jfixtures.make_tiff_tree(str(r / "datasets" / "neurons_nf"),
                                     name="vid.00.00", shape=(32, 32),
                                     nb_frames=6)
    monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(roots["j"]))
    _run_jax_script(monkeypatch, "examples/neurons/nf_videos.py",
                    ["vid.00.00", str(outs["j"])])
    monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(roots["t"]))
    tvideos.main(["vid.00.00", str(outs["t"]), "--device", "cpu"])
    if not ingested:
        with h5py.File(roots["j"] / "datasets" / "neurons_nf" / "vid.00.00"
                       / "dataset.hdf5", "r") as fj, \
                h5py.File(roots["t"] / "datasets" / "neurons_nf"
                          / "vid.00.00" / "dataset.hdf5", "r") as ft:
            for key in ("series/raw", "series/mean", "series/max",
                        "masks/raw", "masks/max"):
                assert ft[key].dtype == fj[key].dtype, key
                assert np.array_equal(ft[key][...], fj[key][...]), key

    def tree(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert tree(outs["t"]) == tree(outs["j"]) != []
    assert any(f.startswith("vid.00.00.") for f in tree(outs["t"]))
    for f in tree(outs["t"]):
        assert (outs["t"] / f).read_bytes() == (outs["j"] / f).read_bytes(), f


# --- 4: unet2ds_sj ----------------------------------------------------------

def test_load_matlab_centers_both_schemas(tmp_path):
    flat = str(tmp_path / "flat.mat")
    scipy.io.savemat(flat, {"centers": np.array([[10.4, 20.6, 3.0],
                                                 [5.5, 7.49, 30.0]]),
                            "radius": 4})
    legacy = str(tmp_path / "legacy.mat")
    # mainAppVars is a struct whose first field holds the (2, N) point
    # coordinates and whose third holds the box radius.
    scipy.io.savemat(legacy, {"appStateData": {"mainAppVars": {
        "pc": np.array([[11.2, 40.7], [9.9, 3.1]]), "mode": 0, "r": 6}}})
    for path in (flat, legacy):
        got, want = tsj.load_matlab_centers(path), jsj.load_matlab_centers(path)
        assert got == want
        assert all(isinstance(v, int) for c in got[0] for v in c)
    assert tsj.load_matlab_centers(flat) == ([(10, 6), (21, 7), (3, 30)], 4)
    assert tsj.load_matlab_centers(legacy) == ([(11, 10), (41, 3)], 6)


def test_unet2ds_sj_matches_jax(ckpt, tmp_path, monkeypatch):
    """The same TIFF tree and annotation through both scripts: the HDF5
    datasets equal, the predicted masks and their submission JSONs equal,
    the outlined PNG equal. The scripts fix the window at 512x512; to keep
    the forward small both wrappers' ``predict`` run at 48x48 here, and
    everything around them is the scripts' own."""
    path, params, state = ckpt
    tree, movie, masks = tfixtures.make_tiff_tree(
        str(tmp_path / "tree"), name="sj.00", shape=(40, 44), nb_frames=10,
        nb_neurons=3)
    glob = os.path.join(tree, "images", "*.tiff")
    mat = str(tmp_path / "centers.mat")
    scipy.io.savemat(mat, {"centers": np.array([[8.0, 20.0, 33.0],
                                                [9.0, 30.0, 12.0]]),
                           "radius": 3})
    results = {}
    for mod in (jsummary, tsummary):
        orig = mod.UNet2DSummary.predict

        def small(self, *a, _orig=orig, _mod=mod, **kw):
            assert kw.pop("window_shape") == (512, 512)
            assert kw["augmentation"] is True and kw["save"] is True
            assert kw["print_scores"] is True
            results[_mod] = _orig(self, *a, window_shape=(48, 48), **kw)
            return results[_mod]

        monkeypatch.setattr(mod.UNet2DSummary, "predict", small)

    files = {}
    for tag in ("j", "t"):
        monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(tmp_path / f"dc_{tag}"))
        argv = ["sj.00", glob, mat, "--model", path]
        if tag == "j":
            _run_jax_script(monkeypatch, "examples/neurons/unet2ds_sj.py",
                            argv, jsj.main)
        else:
            out = tsj.main(argv + ["--device", "cpu"])
            assert out is results[tsummary]
        files[tag] = tmp_path / f"dc_{tag}"
    dsj, dst = (files[t] / "datasets" / "neurons_sj" / "sj.00.hdf5" for t in "jt")
    with h5py.File(dsj, "r") as fj, h5py.File(dst, "r") as ft:
        assert ft.attrs["name"] == fj.attrs["name"] == "sj.00"
        for key in ("series/raw", "series/mean", "series/max", "masks/raw",
                    "masks/max"):
            assert ft[key].dtype == fj[key].dtype
            np.testing.assert_array_equal(ft[key][...], fj[key][...])
        assert ft["masks/raw"].shape == (3, 40, 44)
    (jMp, jnames), (tMp, tnames) = results[jsummary], results[tsummary]
    assert tnames == jnames == ["sj.00"]
    np.testing.assert_array_equal(tMp[0], np.asarray(jMp[0]))
    assert 0 < tMp[0].mean() < 1
    subs = []
    for submit, Mp, tag in ((jnf_submit, jMp, "j"), (tnf_submit, tMp, "t")):
        p = str(tmp_path / f"sub_{tag}.json")
        submit(Mp, ["sj.00"], p)
        subs.append(json.load(open(p)))
    assert subs[0] == subs[1] and subs[1][0]["regions"]
    from PIL import Image

    pngs = [np.asarray(Image.open(
        files[t] / "checkpoints" / "neurons_unet2ds_sj" / "sj.00_mp.png"))
        for t in "jt"]
    np.testing.assert_array_equal(pngs[1], pngs[0])

    # --dataset-path, no annotation: a dataset without masks, no scores.
    seen = {}
    monkeypatch.setattr(tsummary.UNet2DSummary, "predict",
                        lambda self, paths, **kw: seen.update(kw, paths=paths))
    other = str(tmp_path / "other.hdf5")
    tsj.main(["sj.01", glob, "--model", path, "--dataset-path", other,
              "--device", "cpu"])
    assert seen["paths"] == [other] and seen["print_scores"] is False
    with h5py.File(other, "r") as fp:
        assert "masks" not in fp and fp.attrs["name"] == "sj.01"


# --- 5: the hyperparameter search -------------------------------------------

def test_search_space_and_sample_stream_match_jax():
    assert list(tsearch.SPACE.items()) == list(jsearch.SPACE.items())
    rj, rt = np.random.default_rng(865), np.random.default_rng(865)
    for _ in range(20):
        assert tsearch.sample(rt) == jsearch.sample(rj)
    # A narrowed space keeps its key order and draws only from what is left.
    narrow = {**tsearch.SPACE, "nfb": [32]}
    cfgs = [tsearch.sample(rt, narrow) for _ in range(10)]
    assert all(list(c) == list(tsearch.SPACE) and c["nfb"] == 32 for c in cfgs)
    assert len({c["window"] for c in cfgs}) > 1


@pytest.mark.parametrize("mode", ["z", "unit", "sym"])
def test_scaled_summary_func_matches_jax(mode, tmp_path):
    """Within 1e-6 absolute: both read the same float16 mean and z-score it
    in float32."""
    ds = jfixtures.make_neurons_hdf5(str(tmp_path / "d.hdf5"), shape=(32, 32),
                                     nb_frames=8)
    got, want = (m.scaled_summary_func(mode)(ds) for m in (tsearch, jsearch))
    assert got.shape == want.shape == (32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    lo, hi = {"z": (None, None), "unit": (0, 1), "sym": (-1, 1)}[mode]
    if lo is not None:
        assert got.min() == lo and got.max() == hi
    # The injected summary takes the file reader's place.
    z = np.arange(12, dtype=np.float32).reshape(3, 4)
    f = tsearch.scaled_summary_func(mode, {"k": z}.__getitem__)
    want = {"z": z, "unit": z / 11, "sym": 2 * z / 11 - 1}[mode]
    np.testing.assert_allclose(f("k"), want, rtol=0, atol=1e-6)


def test_make_hard_fixtures_byte_equal(tmp_path):
    pj = jsearch.make_hard_fixtures(1, str(tmp_path / "j"), seed=7)
    pt = tsearch.make_hard_fixtures(1, str(tmp_path / "t"), seed=7)
    assert [os.path.relpath(p, tmp_path / "t") for p in pt] == \
        [os.path.relpath(p, tmp_path / "j") for p in pj] == \
        [os.path.join("hard0", "dataset.hdf5")]
    with h5py.File(pj[0], "r") as fj, h5py.File(pt[0], "r") as ft:
        assert ft.attrs["name"] == fj.attrs["name"] == "hard.synthetic.00"
        keys = []
        fj.visit(keys.append)
        tkeys = []
        ft.visit(tkeys.append)
        assert tkeys == keys
        for key in keys:
            if isinstance(fj[key], h5py.Dataset):
                assert ft[key].dtype == fj[key].dtype
                assert ft[key][...].tobytes() == fj[key][...].tobytes(), key


def test_search_load_rows_drops_a_torn_last_line(tmp_path):
    rows = [{"window": "64", "trial": "0", "val_nf_f1_mean": "0.81",
             "seconds": "123.4"},
            {"window": "48", "trial": "1", "val_nf_f1_mean": "nan",
             "seconds": "456.7"}]
    p = tmp_path / "search.csv"
    tsearch.write_rows(str(p), rows)
    assert not (tmp_path / "search.csv.tmp").exists()
    text = p.read_text()
    jp = tmp_path / "j.csv"
    jsearch.write_rows(str(jp), rows)
    assert jp.read_text() == text
    for cut in (text, text[:text.rfind("456.7") + 1], text + "96,2,0.9",
                text.split("\n")[0] + "\n", "", text + "96,2,torn,1.0\n"):
        p.write_text(cut)
        assert tsearch.load_rows(str(p)) == jsearch.load_rows(str(p))
    p.write_text(text[:text.rfind("456.7") + 1])
    assert tsearch.load_rows(str(p)) == rows[:1]


@pytest.mark.parametrize("argv, message", [
    (["x", "--steps", "10", "--steps-per-dispatch", "3"],
     "--steps-per-dispatch 3 must be >= 1 and divide --steps 10"),
    (["x", "--steps-per-dispatch", "0"], "must be >= 1 and divide"),
    (["x", "--resume"], "--resume requires --out"),
])
def test_search_fails_fast_on_bad_flags(argv, message, monkeypatch, capsys):
    """Both ``ap.error`` checks, before any dataset is looked for, with the
    JAX script's messages."""
    with pytest.raises(SystemExit) as exc:
        tsearch.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    terr = capsys.readouterr().err
    assert message in terr
    with pytest.raises(SystemExit):
        _run_jax_script(monkeypatch, "unet2ds_hyperparam_search.py", argv,
                        jsearch.main)
    jerr = capsys.readouterr().err
    assert jerr.strip().splitlines()[-1].split("error: ")[1] == \
        terr.strip().splitlines()[-1].split("error: ")[1]


def test_search_needs_a_card_by_default(tmp_path):
    """A missing card is one error before the first trial, not a sweep of
    NaN rows."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    out = tmp_path / "s.csv"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.main(["x", "--paths", "/no/such.hdf5", "--out", str(out)])
    assert not out.exists()


TINY_SPACE = {**tsearch.SPACE, "window": [32], "nfb": [4], "batch": [4]}


@pytest.fixture(scope="module")
def search_run(tmp_path_factory):
    """A 2-trial run of the port's search on two fixture files, then a
    ``--resume`` to 3 rows; returns (csv path, rows after 2, rows after 3,
    printed text)."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("search")
    old = os.environ.get("DEEPCALCIUM_TPU_DIR")
    os.environ["DEEPCALCIUM_TPU_DIR"] = str(root / "dc")
    try:
        paths = [jfixtures.make_neurons_hdf5(
            str(root / f"d{i}.hdf5"), name=f"search.0{i}", shape=(48, 48),
            nb_frames=8, seed=i) for i in range(2)]
        out = str(root / "search.csv")
        argv = ["x", "--paths", *paths, "--epochs", "1", "--steps", "2",
                "--steps-per-dispatch", "2", "--val-shape", "48", "--out", out,
                "--seed", "11", "--device", "cpu"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tsearch.main(argv + ["--trials", "2"], space=TINY_SPACE)
        two = tsearch.load_rows(out)
        with contextlib.redirect_stdout(buf):
            tsearch.main(argv + ["--trials", "3", "--resume"], space=TINY_SPACE)
        three = tsearch.load_rows(out)
    finally:
        if old is None:
            del os.environ["DEEPCALCIUM_TPU_DIR"]
        else:
            os.environ["DEEPCALCIUM_TPU_DIR"] = old
    return out, two, three, buf.getvalue()


def test_search_writes_the_jax_scripts_columns(search_run):
    out, two, three, printed = search_run
    with open(out) as fp:
        header = next(csv.reader(fp))
    want = list(jsearch.SPACE) + ["trial", "val_nf_f1_mean", "seconds"]
    assert header == want
    # The header of a CSV that the JAX script wrote.
    with open(os.path.join(REPO, "docs", "hyperparam_search_r4.csv")) as fp:
        assert next(csv.reader(fp)) == want
    assert len(two) == 2 and [r["trial"] for r in two] == ["0", "1"]
    rng = np.random.default_rng(11)
    for row in two:
        cfg = tsearch.sample(rng, TINY_SPACE)
        assert {k: str(v) for k, v in cfg.items()} == {k: row[k] for k in cfg}
        assert np.isfinite(float(row["val_nf_f1_mean"])), row
        assert float(row["seconds"]) >= 0
    assert printed.count("results: " + out) == 2
    assert printed.count("best: {") == 2


def test_search_resume_continues_the_stream(search_run):
    out, two, three, printed = search_run
    assert len(three) == 3 and three[:2] == two
    rng = np.random.default_rng(11)
    cfgs = [tsearch.sample(rng, TINY_SPACE) for _ in range(3)]
    assert {k: str(v) for k, v in cfgs[2].items()} == \
        {k: three[2][k] for k in cfgs[2]}
    assert three[2]["trial"] == "2"


def test_search_trial_failure_is_a_nan_row(search_run, tmp_path, monkeypatch):
    """The script's contract: a failing trial is a NaN row, and the sweep
    goes on. ``--rerun-top`` then ranks only the finite rows."""
    out, two, three, printed = search_run
    calls = []

    def fit(self, paths, **kw):
        calls.append(kw)
        if len(calls) == 1:
            raise FloatingPointError("diverged")
        return {"val_nf_f1_mean": [0.25, 0.5]}, "best.ckpt"

    monkeypatch.setattr(tsummary.UNet2DSummary, "fit", fit)
    monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(tmp_path / "dc"))
    csv_path = str(tmp_path / "nan.csv")
    tsearch.main(["x", "--paths", "a.hdf5", "--trials", "2", "--steps", "20",
                  "--out", csv_path, "--device", "cpu"], space=TINY_SPACE)
    rows = tsearch.load_rows(csv_path)
    assert [r["val_nf_f1_mean"] for r in rows] == ["nan", "0.5"]
    assert calls[0]["steps_per_dispatch"] == 10 and calls[0]["nb_steps_trn"] == 20
    assert calls[1]["seed"] == 865 + 1
    tsearch.main(["x", "--paths", "a.hdf5", "--rerun-top", "5", "--epochs", "4",
                  "--steps", "20", "--out", csv_path, "--device", "cpu"],
                 space=TINY_SPACE)
    top = tsearch.load_rows(csv_path[:-4] + "_top5_e4.csv")
    assert [r["trial"] for r in top] == ["1"] and calls[2]["nb_epochs"] == 4
    assert calls[2]["learning_rate"] == float(rows[1]["learning_rate"])


def test_search_passes_the_model_axes_to_the_net(monkeypatch, tmp_path):
    """``fit`` builds its net through ``net_func`` without overriding nfb,
    up_mode, drp or init_scheme."""
    cfg = {**tsearch.sample(np.random.default_rng(0), TINY_SPACE),
           "up_mode": "upsampling", "drp": 0.0, "init_scheme": "glorot_uniform"}
    model = tsearch._wrapper(cfg, str(tmp_path / "cp"), "cpu")
    net = model.net_func(compute_dtype=None, remat=False,
                         generator=torch.Generator().manual_seed(0))
    assert (net.nfb, net.up_mode, net.drp, net.init_scheme) == (
        4, "upsampling", 0.0, "glorot_uniform")
    lim = (6.0 / (9 * 1 + 9 * 4)) ** 0.5
    assert 0.9 * lim < net.enc0a_conv.weight.abs().max().item() <= lim * (1 + 1e-6)


def test_hyperparam_marginals_reads_the_torch_csv(search_run, capsys):
    """One file serves both packages: it imports neither."""
    out, two, three, printed = search_run
    hyperparam_marginals.main(out)
    text = capsys.readouterr().out
    assert f"{out}: 3 trials, mean " in text
    assert "  init_scheme    " in text and "top 10:" in text
    src = open(hyperparam_marginals.__file__).read()
    assert "import jax" not in src and "deepcalcium" not in src.split('"""')[2]


# --- 6: dataset_stats -------------------------------------------------------

def test_dataset_stats_table_and_totals_equal(tmp_path, monkeypatch, capsys):
    paths = [jfixtures.make_neurons_hdf5(
        str(tmp_path / f"d{i}.hdf5"), name=f"stats.0{i}", shape=(32, 40),
        nb_frames=6 + i, nb_neurons=3 + i, seed=i) for i in range(2)]
    test_set = str(tmp_path / "t.hdf5")
    with h5py.File(paths[0], "r") as src, h5py.File(test_set, "w") as dst:
        dst.attrs["name"] = "stats.00.test"
        dst.create_dataset("series/raw", data=src["series/raw"][...])
    argv = ["x", "--paths", *paths, test_set]
    _run_jax_script(monkeypatch, "dataset_stats.py", argv, jstats.main)
    want = capsys.readouterr().out
    tstats.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "stats.01" in got and "totals: 19 frames, 7 neurons" in got
    assert "   nan" in got  # the test set has no masks


def test_dataset_stats_throughput_cell(ckpt, tmp_path, capsys):
    """The cell evaluates the movie it is given through
    ``UNet2DSummary.evaluate_movie`` and prints frames/s with the device's
    name and no figure of another machine."""
    path, params, state = ckpt
    ds = jfixtures.make_neurons_hdf5(str(tmp_path / "d.hdf5"), shape=(32, 32),
                                     nb_frames=6)
    out = tstats.main(["x", "--paths", ds, "--throughput", "--model", path,
                       "--throughput-frames", "12", "--throughput-size", "32",
                       "--device", "cpu"])
    text = capsys.readouterr().out
    line = text.strip().splitlines()[-1]
    assert line.startswith("evaluate throughput (evaluate_movie, 12 frames @ "
                           "32x32, warm, on the CPU): ")
    assert line.endswith(" frames/s") and "8,057" not in text
    for word in ("probe", "MB/s", "backend", "jit"):
        assert word not in line
    movie = tstats._throughput_movie(12, 32)
    assert movie.dtype == np.int16 and movie.shape == (12, 32, 32)
    mask, prob = tsummary.UNet2DSummary(device="cpu").evaluate_movie(
        movie, params=params, state=state, window_shape=(32, 32))
    np.testing.assert_array_equal(out["mask"], mask)
    np.testing.assert_array_equal(out["prob"], prob)
    assert out["frames_per_s"] == 12 / out["seconds"]


# --- 7: activation_maps -----------------------------------------------------

def test_activation_maps_match_jax(ckpt, tmp_path, monkeypatch, capsys):
    """The same 19 file names; pixels within 1/255 (one grey level)."""
    from PIL import Image

    path, params, state = ckpt
    ds = jfixtures.make_neurons_hdf5(str(tmp_path / "d.hdf5"), shape=(40, 44),
                                     nb_frames=8)
    dirs = {t: str(tmp_path / f"maps_{t}") for t in "jt"}
    _run_jax_script(monkeypatch, "activation_maps.py", [ds, path, dirs["j"]],
                    jmaps.main)
    tmaps.main([ds, path, dirs["t"], "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert printed == [f"wrote 19 activation maps to {dirs[t]}" for t in "jt"]
    names = sorted(os.listdir(dirs["t"]))
    assert names == sorted(os.listdir(dirs["j"])) and len(names) == 19
    assert "prediction.png" in names and "mida.png" in names
    for name in names:
        a, b = (np.asarray(Image.open(os.path.join(dirs[t], name)), np.int16)
                for t in "tj")
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, name
    assert np.asarray(Image.open(os.path.join(dirs["t"], "enc0a.png"))).shape \
        == (48, 48)  # 40x44 padded to a square of the next multiple of 16
    probs, acts = tmaps.activation_maps(
        params, state, tsummary.summarize_series(ds), "cpu")
    assert probs.shape == (48, 48) and len(acts) == 18
    assert acts["midb"].shape == (64, 3, 3)


# --- 8: spike_stats ---------------------------------------------------------

def test_spike_stats_match_jax(tmp_path, monkeypatch, capsys):
    """``corpus_stats`` equal, the report byte-equal, both figures written."""
    paths = [jfixtures.make_spikes_hdf5(
        str(tmp_path / f"s{i}.hdf5"), name=f"spk.{i}", nb_traces=7 + i,
        trace_len=300, seed=i) for i in range(2)]
    got, want = (m.corpus_stats(paths, prop_trn=0.75, seed=3)
                 for m in (tspikes, jspikes))
    assert got.keys() == want.keys()
    for key in got:
        if isinstance(got[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key]
    assert got["total_traces"] == 15

    prefix = {t: str(tmp_path / f"out_{t}" / "stats") for t in "jt"}
    argv = ["--paths", *paths, "--prop-trn", "0.75", "--seed", "3",
            "--out-prefix"]
    _run_jax_script(monkeypatch, "spike_stats.py", argv + [prefix["j"]],
                    jspikes.main)
    jout = capsys.readouterr().out
    tspikes.main(argv + [prefix["t"]])
    assert capsys.readouterr().out == jout
    report = open(prefix["t"] + ".txt", "rb").read()
    assert report == open(prefix["j"] + ".txt", "rb").read()
    assert b"corpus: 15 traces" in report
    for suffix in ("_hist.png", "_samples.png"):
        assert os.path.getsize(prefix["t"] + suffix) > 0
        assert os.path.getsize(prefix["j"] + suffix) > 0


def test_spike_fixture_bytes_equal(tmp_path):
    """The corpus the script synthesizes without ``--paths``: the port's
    ``make_spikes_hdf5`` gives the JAX package's bytes."""
    pj = jfixtures.make_spikes_hdf5(str(tmp_path / "j.hdf5"), name="sj.00",
                                    nb_traces=5, trace_len=200,
                                    spike_rate=0.0055, seed=100)
    pt = tfixtures.make_spikes_hdf5(str(tmp_path / "t.hdf5"), name="sj.00",
                                    nb_traces=5, trace_len=200,
                                    spike_rate=0.0055, seed=100)
    with h5py.File(pj, "r") as fj, h5py.File(pt, "r") as ft:
        assert ft.attrs["name"] == fj.attrs["name"]
        for key in ("traces", "spikes"):
            assert ft[key].dtype == fj[key].dtype
            assert ft[key][...].tobytes() == fj[key][...].tobytes()


# --- every script: the card by default --------------------------------------

@pytest.mark.parametrize("main, argv", [
    (tsj.main, ["n", "/no/such/*.tiff", "--model", "m.ckpt"]),
    (tvideos.main, ["vid.00.00", "out"]),
    (tstats.main, ["x", "--paths", "/no/such.hdf5"]),
    (tmaps.main, ["/no/such.hdf5", "/no/such.ckpt", "OUT"]),
    (tnf.main, ["predict", "neurofinder.00.00", "-m", "m.ckpt"]),
    (tspk.main, ["predict", "/no/such.hdf5", "-m", "m.ckpt"]),
], ids=["unet2ds_sj", "nf_videos", "dataset_stats", "activation_maps", "unet2ds_nf",
        "unet1d_spikes"])
def test_scripts_need_a_card_by_default(main, argv, tmp_path, monkeypatch):
    """No ``--device``: the card. Without one a script fails before it reads
    or writes any file; nothing runs on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(tmp_path / "dc"))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("module", [tsearch, tstats, tmaps, tsj, tspikes,
                                    tvideos])
def test_help_states_no_tpu_figures(module, capsys):
    with pytest.raises(SystemExit) as exc:
        module.main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    for figure in ("8,057", "MB/s", "v5e", "TPU", "tunnel", "MXU", "jit",
                   "remote compile"):
        assert figure not in text, figure

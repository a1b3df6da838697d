"""The port's command line (``deepcalcium_torch.cli``) against the JAX
package's, on the CPU (``--device cpu``), on the same fixture files and the
same checkpoint.

The stock net of both CLIs is nfb=32, so frames stay at 48x48 and the movie
at 16 frames, and one checkpoint (random weights from a seed, written by
the port, read by both) serves the module. JAX runs with
``jax.default_matmul_precision("highest")``, since its CLI has no precision
flag and the default truncates float32 convs on some back ends.

Tolerances: ``evaluate-movie``'s prob within 1e-4 absolute (float32 sums in
another order through 23 convs of up to 512 channels); masks equal wherever
the port's own float32 probability lies 1e-4 or more from the threshold;
checkpoints, submissions, ingested datasets and parser defaults equal.
"""

import json
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from deepcalcium_tpu import cli as jcli
from deepcalcium_tpu.data.fixtures import (make_neurons_hdf5,
                                           make_spikes_hdf5, make_tiff_tree)
from deepcalcium_tpu.models import unet_2d_summary as jsummary
from deepcalcium_tpu.train import checkpoints as jckpt
from deepcalcium_torch import cli as tcli
from deepcalcium_torch.data.fixtures import make_keras_unet2ds_hdf5
from deepcalcium_torch.models import unet_2d_summary as tsummary
from deepcalcium_torch.models.unet2d import UNet2DS, from_jax_params, to_jax_params
from deepcalcium_torch.train import checkpoints as tckpt

torch.set_num_threads(1)

BAND = 1e-4
# What the JAX parser's help texts say of its own speed on a TPU.
TPU_FIGURES = ("1.21x", "17%", "16%", "13.6%", "15%", "~2x", "2x MXU",
               "MFU", "MXU", "lax.scan", "round-5", "benchmarked")


def jax_main(argv):
    with jax.default_matmul_precision("highest"):
        jcli.main(argv)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(dataset path, checkpoint path, params, state, directory): a 16-frame
    48x48 fixture movie registered as dataset ``cli.00.00`` of the shared
    datasets directory, and an nfb=32 checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    old = os.environ.get("DEEPCALCIUM_TPU_DIR")
    os.environ["DEEPCALCIUM_TPU_DIR"] = str(root / "dc")
    ds = make_neurons_hdf5(
        str(root / "dc" / "datasets" / "neurons_nf" / "cli.00.00" / "dataset.hdf5"),
        name="cli.00.00", shape=(48, 48), nb_frames=16)
    params, state = to_jax_params(
        UNet2DS(generator=torch.Generator().manual_seed(0)))
    ckpt = tckpt.save_checkpoint(str(root / "m.ckpt"), params, state)
    yield ds, ckpt, params, state, root
    if old is None:
        del os.environ["DEEPCALCIUM_TPU_DIR"]
    else:
        os.environ["DEEPCALCIUM_TPU_DIR"] = old


def _minimal_argv(name):
    return {
        "train": [], "evaluate": ["-m", "m"], "parity-golden": [],
        "predict": ["-m", "m"], "convert": ["a", "b"],
        "spikes-train": ["d"], "spikes-predict": ["d", "-m", "m"],
        "ingest": ["dir", "name"], "evaluate-movie": ["mv", "-m", "m"],
        "segment": ["mv", "-m", "m"]}[name]


SUBCOMMANDS = ["train", "evaluate", "parity-golden", "predict", "convert",
               "spikes-train", "spikes-predict", "ingest", "evaluate-movie",
               "segment"]


def _subparsers(parser):
    (action,) = [a for a in parser._actions if hasattr(a, "choices")
                 and isinstance(a.choices, dict)]
    return action.choices


def test_same_ten_subcommands():
    assert list(_subparsers(tcli.build_parser())) == SUBCOMMANDS
    assert list(_subparsers(jcli.build_parser())) == SUBCOMMANDS
    assert tcli.build_parser().prog == "dc-torch"


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_parser_defaults_match_jax(name):
    """Every flag and default of the JAX parser, plus ``--device``
    (default cuda) wherever a model or a summary is built, and
    ``evaluate-movie``'s ``--arch`` (default unet2ds)."""
    argv = [name] + _minimal_argv(name)
    want = vars(jcli.build_parser().parse_args(argv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("func").__name__ == want.pop("func").__name__
    if name == "evaluate-movie":
        assert got.pop("arch") == "unet2ds"
    if name == "convert":
        assert "device" not in got
    else:
        assert got.pop("device") == "cuda"
    assert got == want
    jsub, tsub = (_subparsers(p.build_parser())[name] for p in (jcli, tcli))
    jflags = {s for a in jsub._actions for s in a.option_strings}
    tflags = {s for a in tsub._actions for s in a.option_strings}
    added = {"convert": set(), "evaluate-movie": {"--device", "--arch"}}
    assert tflags - jflags == added.get(name, {"--device"})
    assert jflags <= tflags
    for a in tsub._actions:
        if a.option_strings and a.choices:
            (ja,) = [b for b in jsub._actions
                     if b.option_strings == a.option_strings] or [None]
            assert ja is None or list(ja.choices) == list(a.choices)


def test_help_states_no_tpu_figures():
    parser = tcli.build_parser()
    texts = [parser.format_help()] + [
        sub.format_help() for sub in _subparsers(parser).values()]
    for text in texts:
        for figure in TPU_FIGURES:
            assert figure not in text, (figure, text)
    joined = " ".join(" ".join(texts).split())
    assert "8x-TTA" in joined  # a property of the method, kept
    assert "no effect in the PyTorch port" in joined
    # K steps a dispatch and the perf preset take effect; the PRNG and the
    # lane-packed step stay the JAX package's no-ops.
    subs = _subparsers(parser)
    for name in ("train", "spikes-train"):
        helps = {a.option_strings[0]: a.help for a in subs[name]._actions
                 if a.option_strings}
        assert "CUDA graph" in helps["--steps-per-dispatch"]
        for flag in ("--steps-per-dispatch", "--preset"):
            assert "no effect" not in helps[flag], (name, flag)
        assert "no effect in the PyTorch port" in helps["--prng-impl"]
    assert "no effect in the PyTorch port" in " ".join(
        a.help for a in subs["train"]._actions
        if a.option_strings == ["--fast-train"])
    # The check has teeth: the JAX parser's help does carry them.
    jtexts = " ".join(sub.format_help() for sub in
                      _subparsers(jcli.build_parser()).values())
    assert "1.21x" in jtexts and "MFU" in jtexts


def test_golden_label_mapping():
    """0.976/1.000/0.988 is the score WITH TTA (the reference loop runs
    the TTA pass first); unchanged from the JAX CLI."""
    assert tcli._GOLDEN_TTA == jcli._GOLDEN_TTA == (0.976, 1.000, 0.988)
    assert tcli._GOLDEN_NO_TTA == jcli._GOLDEN_NO_TTA == (0.919, 1.000, 0.958)
    assert abs(tcli._GOLDEN_TTA[0] - tcli._GOLDEN_NO_TTA[0]) > 0.005
    for tta in ("both", "on", "off"):
        assert tcli._tta_passes(tta) == jcli._tta_passes(tta)
    assert tcli._DTYPES == {"float32": None, "bfloat16": torch.bfloat16}


def test_evaluate_movie_matches_jax(env, capsys):
    ds, ckpt, params, state, root = env
    outs = {}
    for tag, main, extra in (("j", jax_main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        out, png = str(root / f"ev_{tag}.npz"), str(root / f"ev_{tag}.png")
        main(["evaluate-movie", ds, "-m", ckpt, "--window", "48",
              "--out", out, "--png", png] + extra)
        assert os.path.exists(png)
        outs[tag] = dict(np.load(out))
    printed = capsys.readouterr().out
    assert printed.count("mask (48, 48): ") == 2
    assert printed.count("wrote ") == 4
    j, t = outs["j"], outs["t"]
    assert t["mask"].dtype == np.uint8 and t["prob"].dtype == np.float32
    assert t["mask"].shape == t["prob"].shape == (48, 48)
    np.testing.assert_allclose(t["prob"], j["prob"], rtol=0, atol=1e-4)
    far = np.abs(t["prob"] - 0.5) >= BAND
    assert far.mean() > 0.9
    np.testing.assert_array_equal(t["mask"][far], j["mask"][far])


def test_segment_float32_matches_jax(env, capsys):
    ds, ckpt, params, state, root = env
    masks = {}
    for tag, main, extra in (("j", jax_main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        out = str(root / f"masks_{tag}.hdf5")
        main(["segment", ds, "-m", ckpt, "--slab", "8", "--dtype", "float32",
              "--out", out] + extra)
        assert not os.path.exists(out + ".tmp")
        with h5py.File(out, "r") as fp:
            assert fp["masks/frames"].compression == "gzip"
            assert fp["masks/frames"].compression_opts == 1
            masks[tag] = fp["masks/frames"][...]
    assert capsys.readouterr().out.count(": (16, 48, 48), ") == 2
    assert masks["t"].shape == (16, 48, 48) and masks["t"].dtype == np.uint8
    # The port's own float32 probabilities, through the unfolded net.
    with h5py.File(ds, "r") as fp:
        x = torch.from_numpy(fp["series/raw"][...].astype(np.float32))
    x = (x - x.mean(dim=(1, 2), keepdim=True)) / (
        x.std(dim=(1, 2), correction=0, keepdim=True) + 1e-6)
    with torch.inference_mode():
        probs = from_jax_params(params, state).eval()(x).numpy()
    far = np.abs(probs - 0.5) >= BAND
    assert far.mean() > 0.9
    np.testing.assert_array_equal(masks["t"][far], masks["j"][far])
    np.testing.assert_array_equal(masks["t"][far], (probs > 0.5)[far])


def test_segment_default_output_path_and_dtype(env, monkeypatch):
    """Without --out the stack lands beside the movie; the default dtype is
    bfloat16, ``segment_movie``'s own."""
    ds, ckpt, params, state, root = env
    seen = {}

    def fake_segment(params, state, movie, **kw):
        seen.update(kw, shape=movie.shape)
        return np.zeros(movie.shape, np.uint8)

    monkeypatch.setattr(
        "deepcalcium_torch.models.movie_segmentation.segment_movie",
        fake_segment)
    tcli.main(["segment", ds, "-m", ckpt, "--device", "cpu"])
    out = os.path.splitext(ds)[0] + "_masks.hdf5"
    with h5py.File(out, "r") as fp:
        assert fp["masks/frames"].shape == (16, 48, 48)
    os.remove(out)
    assert seen == {"slab": 64, "threshold": 0.5, "device": "cpu",
                    "compute_dtype": torch.bfloat16, "shape": (16, 48, 48)}


def test_convert_reads_in_both_packages(tmp_path, capsys):
    src = make_keras_unet2ds_hdf5(str(tmp_path / "keras.hdf5"), nfb=4)
    jdst, tdst = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jcli.main(["convert", src, jdst])
    tcli.main(["convert", src, tdst])
    assert capsys.readouterr().out.split() == [jdst, tdst]
    raws = [tckpt.read_checkpoint(p) for p in (jdst, tdst)]
    for raw in raws:
        assert raw["meta"] == {"source": os.path.abspath(src),
                               "arch": "unet2ds"}
    # Each package reads the other's file; every leaf equal.
    jraw = jckpt.load_checkpoint(tdst, raws[0]["params"], raws[0]["state"])
    for tree_j, tree_a, tree_b in (
            (jraw[0], raws[0]["params"], raws[1]["params"]),
            (jraw[1], raws[0]["state"], raws[1]["state"])):
        assert sorted(tree_a) == sorted(tree_b) == sorted(tree_j)
        for layer in tree_a:
            for leaf in tree_a[layer]:
                np.testing.assert_array_equal(tree_a[layer][leaf],
                                              tree_b[layer][leaf])
                np.testing.assert_array_equal(np.asarray(tree_j[layer][leaf]),
                                              tree_b[layer][leaf])


def test_predict_submissions_equal(env, monkeypatch):
    """Both CLIs' ``predict`` on the registered dataset: the same four
    submission files with the same content. The CLIs fix the window at
    512x512; to keep the nfb=32 forward small, both wrappers' ``predict``
    are run at 48x48 here, and everything around them is the CLIs' own."""
    ds, ckpt, params, state, root = env
    for mod in (jsummary, tsummary):
        orig = mod.UNet2DSummary.predict

        def small(self, *a, _orig=orig, **kw):
            assert kw.pop("window_shape") == (512, 512)
            return _orig(self, *a, window_shape=(48, 48), **kw)

        monkeypatch.setattr(mod.UNet2DSummary, "predict", small)
    subs = {}
    for tag, main, extra in (("j", jax_main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        cpdir = root / f"cp_{tag}"
        main(["predict", "cli.00.00", "-m", ckpt, "-c", str(cpdir)] + extra)
        names = sorted(os.listdir(cpdir))
        assert [n for n in names if "latest" in n] == [
            "submission_latest.json", "submission_latest_TTA.json"]
        assert len(names) == 4 and sum("_TTA" in n for n in names) == 2
        subs[tag] = {n: json.load(open(cpdir / n)) for n in names
                     if "latest" in n}
        for n in names:
            if "latest" not in n:
                twin = n.replace(n.split("_")[1].split(".")[0], "latest")
                assert json.load(open(cpdir / n)) == subs[tag][twin]
    assert subs["t"] == subs["j"]
    sub = subs["t"]["submission_latest_TTA.json"]
    assert [e["dataset"] for e in sub] == ["cli.00.00"]


def test_parity_golden_offline(env, capsys):
    """The whole glue (load -> predict -> score -> compare -> exit code)
    offline through --paths and -m: PASS inside a wide tolerance, exit code
    1 at an impossible expectation."""
    ds, ckpt, params, state, root = env
    argv = ["parity-golden", "--paths", ds, "-m", ckpt, "--window", "48",
            "--tta", "off", "--device", "cpu"]
    tcli.main(argv + ["--tol", "1.0"])
    out = capsys.readouterr().out
    assert "parity-golden: PASS" in out and "[no-TTA] prec: got " in out
    assert out.count(" -> ok") == 3 and "[TTA]" not in out

    with pytest.raises(SystemExit) as exc:
        tcli.main(argv + ["--tol", "0.000001", "--expect-no-tta", "9", "9", "9"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "parity-golden: FAIL (3 score(s) out of tolerance)" in out
    assert out.count(" -> FAIL") == 3


def test_parity_golden_scores_match_jax(env, capsys):
    ds, ckpt, params, state, root = env
    argv = ["parity-golden", "--paths", ds, "-m", ckpt, "--window", "48",
            "--tta", "on", "--tol", "1.0"]
    jax_main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert "[TTA] comb: got " in want


def test_train_and_evaluate_pass_their_flags_on(env, monkeypatch, capsys):
    """``train`` and ``evaluate`` hand the wrapper what the JAX CLI hands
    it (their nets run at 512x512, too large to run here)."""
    ds, ckpt, params, state, root = env
    calls = []
    for mod in (jsummary, tsummary):
        monkeypatch.setattr(
            mod.UNet2DSummary, "fit",
            lambda self, paths, **kw: calls.append(
                ("fit", list(paths), kw, self.remat, self.compute_dtype))
            or ({}, "best.ckpt"))
        monkeypatch.setattr(
            mod.UNet2DSummary, "predict",
            lambda self, paths, **kw: calls.append(
                ("predict", list(paths), kw, self.compute_dtype)))
    train = ["train", "cli.00.00", "-w", "256", "-b", "4", "-s", "8", "-e", "2",
             "--loss", "dice_loss", "--lr-schedule", "cosine",
             "--steps-per-dispatch", "4", "--fast-train", "off",
             "--weight-decay", "0.01", "--prng-impl", "rbg", "--ema-decay",
             "0.9", "--preset", "perf", "--seed", "7", "-m", ckpt]
    evaluate = ["evaluate", "cli.00.00", "-m", ckpt, "--dtype", "bfloat16"]
    jcli.main(train)
    jcli.main(evaluate)
    want, calls[:] = list(calls), []
    tcli.main(train + ["--device", "cpu"])
    tcli.main(evaluate + ["--device", "cpu"])
    assert capsys.readouterr().out.count("best checkpoint: best.ckpt") == 2
    assert len(calls) == len(want) == 3
    for got, exp in zip(calls, want):
        assert got[:3] == exp[:3]
    assert calls[0][3] is True and want[0][3] is True   # remat at 256
    assert calls[1][3] == torch.bfloat16 and want[1][3] == "bfloat16"
    assert [c[2]["augmentation"] for c in calls[1:]] == [True, False]


@pytest.fixture(scope="module")
def spikes(tmp_path_factory):
    d = tmp_path_factory.mktemp("spikes")
    return [make_spikes_hdf5(str(d / f"s{i}.hdf5"), name=f"spikes.{i}",
                             nb_traces=6, trace_len=256, seed=i)
            for i in range(2)]


def test_spikes_train_glm_and_predict(spikes, tmp_path, capsys):
    """``spikes-train --arch glm`` trains and names its checkpoint; both
    CLIs' ``spikes-predict`` of that checkpoint print the same lines."""
    cp = str(tmp_path / "cp")
    tcli.main(["spikes-train", *spikes, "--arch", "glm", "-c", cp, "-e", "30",
               "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("best: ") and "(val_F2=" in line
    ckpt = line.split()[1]
    assert os.path.exists(ckpt) and ckpt.startswith(cp)

    argv = ["spikes-predict", *spikes, "-m", ckpt, "--arch", "glm", "-c", cp]
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[0].startswith("spikes.0: (6, 256), ")

    with pytest.raises(SystemExit, match="unet1d-only"):
        tcli.main(["spikes-train", *spikes, "--arch", "stm", "--val_type",
                   "cross_validate", "--device", "cpu"])


def test_spikes_train_unet1d_passes_its_flags_on(spikes, monkeypatch, capsys):
    from deepcalcium_tpu.models import unet_1d_segmentation as jseg
    from deepcalcium_torch.models import unet_1d_segmentation as tseg

    calls = []
    for mod in (jseg, tseg):
        monkeypatch.setattr(
            mod.UNet1DSegmentation, "fit",
            lambda self, paths, **kw: calls.append((list(paths), kw))
            or ({}, {}, "best1d.ckpt"))
    argv = ["spikes-train", *spikes, "-e", "3", "--steps-per-dispatch", "2",
            "--weight-decay", "0.1", "--prng-impl", "rbg", "--preset", "parity"]
    jcli.main(argv)
    tcli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.split() == ["best:", "best1d.ckpt"] * 2
    assert calls[0] == calls[1]
    assert calls[0][1]["val_type"] == "random_split"


def test_ingest_matches_jax(tmp_path, capsys):
    trees = {}
    for tag in ("j", "t"):
        trees[tag], movie, masks = make_tiff_tree(
            str(tmp_path / tag), name="tree.00.00", shape=(24, 28),
            nb_frames=10, nb_neurons=3)
    jcli.main(["ingest", trees["j"], "tree.00.00"])
    tcli.main(["ingest", trees["t"], "tree.00.00", "--device", "cpu"])
    assert capsys.readouterr().out.split() == [
        os.path.join(trees[t], "dataset.hdf5") for t in ("j", "t")]
    with h5py.File(os.path.join(trees["j"], "dataset.hdf5"), "r") as fj, \
            h5py.File(os.path.join(trees["t"], "dataset.hdf5"), "r") as ft:
        assert ft.attrs["name"] == fj.attrs["name"] == "tree.00.00"
        for key in ("series/raw", "series/max", "masks/raw", "masks/max"):
            assert ft[key].dtype == fj[key].dtype
            np.testing.assert_array_equal(ft[key][...], fj[key][...])
        np.testing.assert_array_equal(ft["series/raw"][...], movie)
        # The mean is stored float16: both round the same float32 mean
        # (exact integer sums of 10 frames divided by 10).
        assert ft["series/mean"].dtype == fj["series/mean"].dtype == np.float16
        np.testing.assert_array_equal(ft["series/mean"][...],
                                      fj["series/mean"][...])


@pytest.mark.parametrize("argv", [
    ["train", "no.such.dataset", "--window", "100"],
    ["train", "no.such.dataset", "--window", "8"],
    ["evaluate-movie", "/no/such/movie.hdf5", "-m", "/no/such.ckpt",
     "--window", "40"],
])
def test_window_check_fails_before_any_io(argv):
    """A dataset that does not exist is never looked for."""
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="must be a multiple of 16"):
            main(argv + extra)


def test_commands_need_a_card_by_default(env):
    """No --device: the card. Without one the command fails before it reads
    a dataset or builds a model; nothing runs on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this pins the behaviour "
                    "without one")
    ds, ckpt, params, state, root = env
    for argv in (["segment", ds, "-m", ckpt],
                 ["evaluate-movie", ds, "-m", ckpt, "--window", "48"],
                 ["predict", "cli.00.00", "-m", ckpt],
                 ["train", "no.such.dataset"],
                 ["spikes-predict", "x.hdf5", "-m", "y.ckpt"],
                 ["ingest", str(root), "name"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)


def test_module_runs_as_a_script():
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-m", "deepcalcium_torch.cli", "--help"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert all(name in proc.stdout for name in SUBCOMMANDS)

"""Command-line interface: train / evaluate / predict on Neurofinder data.

Port of ``deepcalcium_tpu.cli``: the same ten subcommands, flags, defaults,
printed lines and output files (timestamped and ``latest`` submission
JSONs, the ``masks/frames`` stack of ``segment``, the ``.npz`` and outlined
PNG of ``evaluate-movie``). One flag is added: ``--device {cuda,cpu}`` on
every subcommand that builds a model or a summary. The default is the card,
and without one a command fails: nothing falls back to the CPU.

Usage:
    python -m deepcalcium_torch.cli train all_train
    python -m deepcalcium_torch.cli evaluate neurofinder.00.00 -m model.ckpt
    python -m deepcalcium_torch.cli predict all_test -m model.ckpt
    python -m deepcalcium_torch.cli spikes-train data1.hdf5 data2.hdf5
    python -m deepcalcium_torch.cli ingest /path/to/tiffdir name
"""

import argparse
import contextlib
import logging
import os
import time

import torch

from deepcalcium_torch.utils.config import checkpoints_dir


def _neurons_cpdir(override=None):
    return override or os.path.join(checkpoints_dir(), "neurons_unet2ds_nf")


def _tta_passes(tta: str):
    """'both' mirrors the reference CLI (TTA pass then plain pass);
    'on'/'off' run just one."""
    return {"both": (True, False), "on": (True,), "off": (False,)}[tta]


# float32 = Keras-parity numerics (the wrappers' default); bfloat16 = bf16
# convs with float32 BN statistics and softmax.
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _add_dtype_flag(p, default):
    p.add_argument("--dtype", default=default,
                   choices=["float32", "bfloat16"],
                   help="compute dtype: float32 = reference-parity "
                        "numerics, bfloat16 = bf16 convs")


def _add_device_flag(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; the default fails without a "
                        "CUDA card, 'cpu' runs on the CPU on purpose")


# --- What each command gets its model and its movie through -----------------
# Private: a machine without h5py drives ``main`` by replacing these with
# functions that hand over in-memory arrays through the wrappers' injection
# points.

def _neuron_wrapper(args, **kw):
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary

    return UNet2DSummary(cpdir=_neurons_cpdir(args.checkpoints_dir),
                         device=args.device, **kw)


def _spike_wrapper(args):
    if args.arch in ("glm", "stm"):
        from deepcalcium_torch.models.glm_spikes import GLMSegmentation

        return GLMSegmentation(cpdir=args.checkpoints_dir, arch=args.arch,
                               device=args.device)
    from deepcalcium_torch.models.unet_1d_segmentation import (
        UNet1DSegmentation)

    return UNet1DSegmentation(cpdir=args.checkpoints_dir, device=args.device)


@contextlib.contextmanager
def _open_raw(movie_path):
    """The ``series/raw`` dataset of a contract HDF5, open for slicing."""
    import h5py

    with h5py.File(movie_path, "r") as fp:
        yield fp["series/raw"]


def _write_masks(out_path, masks):
    """The (T, H, W) uint8 stack as ``masks/frames``, through a temporary
    file renamed into place."""
    import h5py

    tmp = out_path + ".tmp"
    with h5py.File(tmp, "w") as fp:
        fp.create_dataset("masks/frames", data=masks,
                          compression="gzip", compression_opts=1)
    os.replace(tmp, out_path)


# --- Commands ---------------------------------------------------------------

def cmd_convert(args):
    """Convert a Keras HDF5 checkpoint (e.g. the released
    unet2ds_model.hdf5) into a native .ckpt snapshot that both packages
    read."""
    from deepcalcium_torch.train.checkpoints import save_checkpoint

    if args.arch == "unet2ds":
        from deepcalcium_torch.interop.keras_import import (
            load_unet2ds_keras as load_keras)
    else:
        from deepcalcium_torch.interop.keras_import import (
            load_unet1d_keras as load_keras)
    params, state = load_keras(args.src)
    save_checkpoint(args.dst, params, state,
                    meta={"source": os.path.abspath(args.src),
                          "arch": args.arch})
    print(args.dst)


def cmd_train(args):
    from deepcalcium_torch.data.nf import nf_load_hdf5

    if args.window % 16 or args.window < 16:
        raise SystemExit(f"--window {args.window} must be a multiple of 16 "
                         f"(4 pooling levels) — failing before the "
                         f"disk-bound dataset summaries")
    dspaths = nf_load_hdf5(args.dataset_name, device=args.device)
    shape_trn = (args.window, args.window)
    # Training at 512^2 windows recommends remat (the activations of batch
    # 20 are large); an explicit flag wins either way.
    remat = args.remat if args.remat is not None else args.window >= 256
    model = _neuron_wrapper(args, remat=remat)
    history, best = model.fit(
        dspaths,
        model_path=args.model_path,
        shape_trn=shape_trn, shape_val=(512, 512),
        batch_size_trn=args.batch, nb_steps_trn=args.steps,
        nb_epochs=args.epochs,
        prop_trn=0.75, prop_val=0.25,
        loss=args.loss, seed=args.seed,
        lr_schedule=args.lr_schedule,
        steps_per_dispatch=args.steps_per_dispatch,
        fast_train={"auto": "auto", "on": True, "off": False}[args.fast_train],
        weight_decay=args.weight_decay,
        prng_impl=args.prng_impl,
        ema_decay=args.ema_decay,
        preset=args.preset,
    )
    print(f"best checkpoint: {best}")
    return history, best


def cmd_evaluate(args):
    from deepcalcium_torch.data.nf import nf_load_hdf5

    dspaths = nf_load_hdf5(args.dataset_name, device=args.device)
    model = _neuron_wrapper(args, compute_dtype=_DTYPES[args.dtype])
    for aug in _tta_passes(args.tta):
        logging.getLogger("evaluate").info(
            "Evaluation with%s.", " TTA" if aug else "out TTA")
        model.predict(dspaths, model_path=args.model_path,
                      window_shape=(512, 512), save=True, print_scores=True,
                      augmentation=aug)


# The reference README's golden numbers for neurofinder.00.00 with the
# released unet2ds_model.hdf5. The label mapping follows the reference's own
# loop order: ``for aug in [True, False]`` runs the TTA pass first, and in
# the README's captured output the 0.976/0.988 block stands before the
# "Evaluation without TTA." header and 0.919/0.958 after it. So 0.976/0.988
# is the score with TTA and 0.919/0.958 the one without.
_GOLDEN_TTA = (0.976, 1.000, 0.988)  # prec, reca, comb
_GOLDEN_NO_TTA = (0.919, 1.000, 0.958)


def cmd_parity_golden(args):
    """One-command golden-parity check: released Keras weights +
    neurofinder.00.00 -> predict (with and without 8x TTA) -> compare the
    prec/reca/comb scores with the reference README's numbers.

    Exit 0 = every score within --tol of expected; exit 1 otherwise.
    ``--paths``/``--model_path``/``--expect-*`` let an offline test (or
    another corpus) drive the same glue.
    """
    import numpy as np

    from deepcalcium_torch.metrics.neurofinder import nf_mask_metrics

    cpdir = _neurons_cpdir(args.checkpoints_dir)
    model_path = args.model_path
    if model_path is None:
        from deepcalcium_torch.utils.model_downloads import (
            UNET2DS_MODEL_URL, download_model)

        os.makedirs(cpdir, exist_ok=True)
        model_path = download_model(
            UNET2DS_MODEL_URL, os.path.join(cpdir, "unet2ds_model.hdf5"))
    if args.paths:
        dspaths = args.paths
    else:
        from deepcalcium_torch.data.nf import nf_load_hdf5

        dspaths = nf_load_hdf5(args.dataset_name, device=args.device)

    model = _neuron_wrapper(args, compute_dtype=_DTYPES[args.dtype])
    passes = []
    if args.tta in ("both", "off"):
        passes.append((False, tuple(args.expect_no_tta or _GOLDEN_NO_TTA)))
    if args.tta in ("both", "on"):
        passes.append((True, tuple(args.expect_tta or _GOLDEN_TTA)))

    # Ground-truth mask summaries once per dataset, not once per pass: the
    # exact sequential walk takes minutes on the host at 512x512.
    summaries = [model.mask_summary_func(dsp) for dsp in dspaths]
    failures = []
    for aug, expected in passes:
        Mp, names = model.predict(dspaths, model_path,
                                  window_shape=(args.window, args.window),
                                  augmentation=aug)
        mp_ = mr_ = mc_ = 0.0
        for m, mp in zip(summaries, Mp):
            p, r, _, _, c = nf_mask_metrics(m, np.round(mp))
            mp_ += p / len(dspaths)
            mr_ += r / len(dspaths)
            mc_ += c / len(dspaths)
        label = "TTA" if aug else "no-TTA"
        for got, exp, nm in zip((mp_, mr_, mc_), expected,
                                ("prec", "reca", "comb")):
            status = "ok" if abs(got - exp) <= args.tol else "FAIL"
            print(f"parity-golden [{label}] {nm}: got {got:.4f} "
                  f"expected {exp:.3f} +/-{args.tol} -> {status}")
            if status == "FAIL":
                failures.append((label, nm, got, exp))
    if failures:
        print(f"parity-golden: FAIL ({len(failures)} score(s) out of "
              f"tolerance)")
        raise SystemExit(1)
    print("parity-golden: PASS")


def cmd_predict(args):
    from deepcalcium_torch.data.nf import nf_load_hdf5, nf_submit

    dspaths = nf_load_hdf5(args.dataset_name, device=args.device)
    model = _neuron_wrapper(args, compute_dtype=_DTYPES[args.dtype])
    tic = int(time.time())
    for aug in _tta_passes(args.tta):
        Mp, names = model.predict(dspaths, model_path=args.model_path,
                                  window_shape=(512, 512), augmentation=aug)
        suffix = "_TTA" if aug else ""
        cpdir = model._cpdir()  # created when missing
        nf_submit(Mp, names, os.path.join(
            cpdir, f"submission_{tic}{suffix}.json"))
        nf_submit(Mp, names, os.path.join(
            cpdir, f"submission_latest{suffix}.json"))


def cmd_spikes_train(args):
    baseline = args.arch in ("glm", "stm")
    if baseline and args.val_type != "random_split":
        raise SystemExit(
            f"--val_type {args.val_type} is unet1d-only (the GLM/STM "
            f"baseline trains full-batch on one random split)")
    model = _spike_wrapper(args)
    if baseline:
        # GLM epochs are full-batch passes; the unet default (20) is far too
        # few, so keep the model's default unless -e was given.
        kw = {"nb_epochs": args.epochs} if args.epochs != 20 else {}
        mt, mv, path = model.fit(args.dataset_paths, **kw)
        print(f"best: {path} (val_F2={mv['F2']:.3f})")
        return
    out = model.fit(args.dataset_paths, val_type=args.val_type,
                    nb_epochs=args.epochs,
                    steps_per_dispatch=args.steps_per_dispatch,
                    weight_decay=args.weight_decay,
                    prng_impl=args.prng_impl,
                    preset=args.preset)
    print(out if args.val_type == "cross_validate" else f"best: {out[2]}")


def cmd_spikes_predict(args):
    model = _spike_wrapper(args)
    preds, names = model.predict(args.dataset_paths, args.model_path)
    for n, p in zip(names, preds):
        print(f"{n}: {p.shape}, {int(p.sum())} spike samples")


def cmd_ingest(args):
    from deepcalcium_torch.data.nf import ingest_tiff_dataset

    out = ingest_tiff_dataset(
        args.tiff_dir, os.path.join(args.tiff_dir, "dataset.hdf5"), args.name,
        device=args.device)
    print(out)


def cmd_evaluate_movie(args):
    """Summary -> TTA -> threshold evaluate of a raw movie file; the movie
    streams from the file in chunks and is never held whole."""
    import numpy as np

    from deepcalcium_torch.utils.visualization import mask_outlines, save_png

    if args.window % 16 or args.window < 16:
        raise SystemExit(f"--window {args.window} must be a multiple of 16 "
                         f"(4 pooling levels) — failing before the movie "
                         f"summary pass")
    model = _neuron_wrapper(args, compute_dtype=_DTYPES[args.dtype])
    with _open_raw(args.movie) as raw:
        mask, prob = model.evaluate_movie(
            raw, model_path=args.model_path,
            window_shape=(args.window, args.window), tta=not args.no_tta,
            threshold=args.threshold)
    print(f"mask {mask.shape}: {int(mask.sum())} positive px "
          f"({mask.mean():.2%}); prob range "
          f"[{prob.min():.3f}, {prob.max():.3f}]")
    if args.out:
        np.savez(args.out, mask=mask, prob=prob)
        print(f"wrote {args.out}")
    if args.png:
        # mask_outlines percentile-clips and normalises internally.
        save_png(args.png, mask_outlines(prob, [mask], ["red"]))
        print(f"wrote {args.png}")


def cmd_segment(args):
    """Per-frame segmentation of a raw movie; writes a (T, H, W) uint8 mask
    stack next to the input."""
    import numpy as np

    from deepcalcium_torch.models.movie_segmentation import segment_movie

    model = _neuron_wrapper(args)
    params, state = model._load_params(args.model_path)
    out_path = args.out or (os.path.splitext(args.movie)[0] + "_masks.hdf5")
    with _open_raw(args.movie) as raw:
        masks = segment_movie(params, state, raw,
                              slab=args.slab, threshold=args.threshold,
                              compute_dtype=_DTYPES[args.dtype],
                              device=args.device)
    _write_masks(out_path, masks)
    print(f"wrote {out_path}: {masks.shape}, "
          f"{float(np.mean(masks)):.2%} positive")


_NO_EFFECT = ("accepted for scripts written for the JAX package; checked "
              "and logged, no effect in the PyTorch port")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="dc-torch", description="deep-calcium CLI of the PyTorch port.")
    sp = ap.add_subparsers(title="actions", required=True)

    p = sp.add_parser("train", help="Train UNet2DS on Neurofinder datasets.")
    p.add_argument("dataset_name", nargs="?", default="all_train", type=str)
    p.add_argument("-m", "--model_path")
    p.add_argument("-c", "--checkpoints_dir")
    p.add_argument("-e", "--epochs", type=int, default=10)
    p.add_argument("-w", "--window", type=int, default=128,
                   help="training window side (128 = reference recipe; "
                        "512 trains at full images, auto-enables remat)")
    p.add_argument("-b", "--batch", type=int, default=20)
    p.add_argument("-s", "--steps", type=int, default=100,
                   help="train steps per epoch (reference recipe: 100)")
    p.add_argument("--seed", type=int, default=865,
                   help="RNG seed (the reference CLI seeds 865)")
    p.add_argument("--loss", default="binary_crossentropy",
                   choices=["binary_crossentropy",
                            "weighted_binary_crossentropy", "dice_loss",
                            "dicesq_loss"])
    p.add_argument("--lr-schedule", default="plateau",
                   choices=["plateau", "cosine"])
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="training steps run as one dispatch, one CUDA graph "
                        "of K steps on the card (must divide --steps)")
    p.add_argument("--fast-train", default="auto",
                   choices=["auto", "on", "off"],
                   help="the JAX package's lane-packed gradient step; "
                        + _NO_EFFECT)
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="AdamW decoupled weight decay on conv kernels "
                        "(the reference search's L2 axis)")
    p.add_argument("--prng-impl", default="threefry2x32",
                   choices=["threefry2x32", "rbg"],
                   help="the JAX package's dropout PRNG; " + _NO_EFFECT
                        + " (dropout draws from torch's Philox stream)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="exponential moving average of params for eval")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="rematerialize conv blocks in the backward pass "
                        "(default: on for window >= 256)")
    p.add_argument("--preset", default=None, choices=["parity", "perf"],
                   help="perf: the first of 4, 2, 1 steps per dispatch that "
                        "divides --steps (the JAX package's rbg PRNG, its "
                        "other lever, has no counterpart); parity: the "
                        "defaults")
    _add_device_flag(p)
    p.set_defaults(func=cmd_train)

    p = sp.add_parser("evaluate", help="Evaluate with and without TTA.")
    p.add_argument("dataset_name", nargs="?", default="all_train", type=str)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-c", "--checkpoints_dir")
    _add_dtype_flag(p, "float32")
    p.add_argument("--tta", default="both", choices=["both", "on", "off"],
                   help="'both' runs a TTA pass then a plain pass "
                        "(reference behavior)")
    _add_device_flag(p)
    p.set_defaults(func=cmd_evaluate)

    p = sp.add_parser(
        "parity-golden",
        help="Golden-parity check: released weights + neurofinder.00.00 "
             "vs the reference README scores; exit 1 on mismatch.")
    p.add_argument("dataset_name", nargs="?", default="neurofinder.00.00",
                   type=str)
    p.add_argument("-m", "--model_path",
                   help="checkpoint to use (default: download the released "
                        "unet2ds_model.hdf5)")
    p.add_argument("-c", "--checkpoints_dir")
    p.add_argument("--paths", nargs="+",
                   help="explicit contract-HDF5 paths (bypasses the "
                        "Neurofinder registry/download; offline testing)")
    p.add_argument("--tta", default="both", choices=["both", "on", "off"])
    p.add_argument("--tol", type=float, default=0.005,
                   help="absolute score tolerance (README prints 3 "
                        "decimals; default covers rounding + float "
                        "reassociation)")
    p.add_argument("--window", type=int, default=512,
                   help="inference pad size (512 = the reference golden "
                        "setup; smaller only for offline fixture tests)")
    p.add_argument("--expect-no-tta", nargs=3, type=float, metavar="S",
                   help="expected (prec, reca, comb) for the no-TTA pass "
                        "(default: the README golden 0.919 1.000 0.958 — "
                        "the reference loop runs TTA first, so the "
                        "README's SECOND score block is the no-TTA one)")
    p.add_argument("--expect-tta", nargs=3, type=float, metavar="S",
                   help="expected (prec, reca, comb) for the 8x-TTA pass "
                        "(default: the README golden 0.976 1.000 0.988)")
    _add_dtype_flag(p, "float32")
    _add_device_flag(p)
    p.set_defaults(func=cmd_parity_golden)

    p = sp.add_parser("predict", help="Predict + write submission JSONs.")
    p.add_argument("dataset_name", nargs="?", default="all", type=str)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-c", "--checkpoints_dir")
    _add_dtype_flag(p, "float32")
    p.add_argument("--tta", default="both", choices=["both", "on", "off"])
    _add_device_flag(p)
    p.set_defaults(func=cmd_predict)

    p = sp.add_parser("convert",
                      help="Convert a Keras .hdf5 into a native .ckpt.")
    p.add_argument("src", help="Keras HDF5 checkpoint")
    p.add_argument("dst", help="output .ckpt path")
    p.add_argument("--arch", default="unet2ds", choices=["unet2ds", "unet1d"])
    p.set_defaults(func=cmd_convert)

    p = sp.add_parser("spikes-train", help="Train UNet1D/GLM on spike datasets.")
    p.add_argument("dataset_paths", nargs="+")
    p.add_argument("-c", "--checkpoints_dir")
    p.add_argument("-e", "--epochs", type=int, default=20)
    p.add_argument("--arch", default="unet1d", choices=["unet1d", "glm", "stm"])
    p.add_argument("--val_type", default="random_split",
                   choices=["random_split", "cross_validate"])
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="training steps run as one dispatch, one CUDA graph "
                        "of K steps on the card (unet1d only; must divide "
                        "the steps of an epoch)")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="AdamW decoupled weight decay (unet1d only)")
    p.add_argument("--prng-impl", default="threefry2x32",
                   choices=["threefry2x32", "rbg"],
                   help="the JAX package's dropout PRNG (unet1d only); "
                        + _NO_EFFECT)
    p.add_argument("--preset", default=None, choices=["parity", "perf"],
                   help="perf (unet1d only): for each split the first of 4, "
                        "2, 1 steps per dispatch that divides its steps (the "
                        "JAX package's rbg PRNG has no counterpart); parity: "
                        "the defaults")
    _add_device_flag(p)
    p.set_defaults(func=cmd_spikes_train)

    p = sp.add_parser("spikes-predict", help="Predict spikes on datasets.")
    p.add_argument("dataset_paths", nargs="+")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-c", "--checkpoints_dir")
    p.add_argument("--arch", default="unet1d", choices=["unet1d", "glm", "stm"])
    _add_device_flag(p)
    p.set_defaults(func=cmd_spikes_predict)

    p = sp.add_parser("ingest", help="Ingest a TIFF tree into contract HDF5.")
    p.add_argument("tiff_dir")
    p.add_argument("name")
    _add_device_flag(p)
    p.set_defaults(func=cmd_ingest)

    p = sp.add_parser(
        "evaluate-movie",
        help="Summary->TTA->threshold evaluate of one raw movie.")
    p.add_argument("movie", help="contract HDF5 (series/raw) path")
    p.add_argument("-m", "--model_path", required=True,
                   help=".ckpt or Keras .hdf5")
    p.add_argument("-c", "--checkpoints_dir")
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--threshold", type=float, default=0.5)
    _add_dtype_flag(p, "float32")
    p.add_argument("--no-tta", action="store_true")
    p.add_argument("--out", help="write mask+prob to this .npz")
    p.add_argument("--png", help="write an outlined summary PNG here")
    _add_device_flag(p)
    p.set_defaults(func=cmd_evaluate_movie)

    p = sp.add_parser(
        "segment",
        help="Per-frame segmentation of a raw movie -> uint8 mask stack.")
    p.add_argument("movie", help="contract HDF5 (series/raw) path")
    p.add_argument("-m", "--model_path", required=True,
                   help=".ckpt or Keras .hdf5")
    p.add_argument("-c", "--checkpoints_dir")
    _add_dtype_flag(p, "bfloat16")  # segment_movie's default
    p.add_argument("--slab", type=int, default=64,
                   help="frames per device batch")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--out", help="output HDF5 (default <movie>_masks.hdf5)")
    _add_device_flag(p)
    p.set_defaults(func=cmd_segment)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if getattr(args, "device", None) == "cuda":
        # Before any download or dataset IO.
        from deepcalcium_torch.utils.device import require_cuda

        require_cuda()
    args.func(args)


if __name__ == "__main__":
    main()

"""Random hyperparameter search for UNet2DS.

Counterpart of ``examples/neurons/unet2ds_hyperparam_search.py``: samples
window shape, learning rate, loss, base filters, dropout,
upsampling-vs-transpose, batch size, weight decay (AdamW), kernel init
scheme and input scaling ([0,1] / [-1,1] / z-score). Trains each config
briefly and ranks by ``val_nf_f1_mean``; results stream to a CSV for
analysis (``examples/analysis/hyperparam_marginals.py`` reads it).

The config stream is the JAX script's: the same ``SPACE`` in the same key
order and the same ``np.random.default_rng(seed)`` draws, so trial *n* of a
seed is the same config in both packages and ``--resume`` continues a CSV
that either script wrote.

With ``--make-fixtures`` the script synthesizes HARD fixtures first
(realistic soft-disk neurons at the Neurofinder corpus's ~0.126
positive-pixel proportion, dim sparse transients) so scores do not saturate.

    python examples_torch/neurons/unet2ds_hyperparam_search.py all_train \
        --trials 50 --epochs 2 [--out search.csv] [--device cpu]
    python examples_torch/neurons/unet2ds_hyperparam_search.py fixtures \
        --make-fixtures 3 --trials 50
"""

import argparse
import csv
import functools
import logging
import os
import sys
import time

sys.path.append(".")

import numpy as np

SPACE = {
    "window": [48, 64, 96],
    "learning_rate": [1e-2, 2e-3, 1e-3, 5e-4],
    "loss": ["binary_crossentropy", "weighted_binary_crossentropy",
             "dice_loss", "dicesq_loss"],
    "nfb": [16, 32],
    "drp": [0.0, 0.25],
    "up_mode": ["transpose", "upsampling"],
    "batch": [16, 32],
    "weight_decay": [0.0, 1e-5, 1e-4, 1e-3],
    "init_scheme": ["he_normal", "he_uniform", "glorot_uniform"],
    "scale_mode": ["z", "unit", "sym"],
}


def sample(rng, space=None):
    """One config: a draw for each key of ``space`` (``SPACE``), in order."""
    space = SPACE if space is None else space
    return {k: v[int(rng.integers(0, len(v)))] for k, v in space.items()}


def scaled_summary_func(mode, summary_func=None):
    """Input-scaling axis: [0,1] (``unit``) vs [-1,1] (``sym``)
    normalization of the summary image; ``z`` is the default (z-score,
    ``models.unet_2d_summary.summarize_series``). ``summary_func`` maps a
    dataset reference to its z-scored summary (default: read the file)."""
    if summary_func is None:
        from deepcalcium_torch.models.unet_2d_summary import summarize_series

        summary_func = summarize_series

    def f(dspath):
        s = summary_func(dspath)  # z-scored
        if mode == "z":
            return s
        lo, hi = float(s.min()), float(s.max())
        u = (s - lo) / max(hi - lo, 1e-9)
        return u if mode == "unit" else 2.0 * u - 1.0

    return f


def make_hard_fixtures(n, out_dir, seed=865):
    """Hard realistic fixtures: ~0.126 positive-pixel proportion (the
    Neurofinder train corpus mean), dim sparse calcium transients."""
    from deepcalcium_torch.data.fixtures import make_realistic_hdf5
    from deepcalcium_torch.models.unet_2d_summary import summarize_mask

    paths = []
    for i in range(n):
        p = os.path.join(out_dir, f"hard{i}", "dataset.hdf5")
        make_realistic_hdf5(
            p, name=f"hard.synthetic.0{i}", shape=(128, 128), nb_frames=96,
            nb_neurons=31, r_lo=3, r_hi=6, amp_lo=40, amp_hi=150,
            spike_rate=0.03, seed=seed + i)
        pos = float(summarize_mask(p).mean())
        logging.info("fixture %s: positive-pixel proportion %.3f", p, pos)
        paths.append(p)
    return paths


def load_rows(path):
    """Read a results CSV, dropping malformed trailing rows (a restart can
    leave a torn last line). A mid-line tear isn't always detectable from
    parsed fields (a 'seconds' value cut from '123.4' to '1' still parses),
    so first drop any final line that lacks its newline terminator, then
    keep rows up to the first one with missing fields or an unparseable
    score: the RNG replay in --resume stays aligned with the row count."""
    import io
    with open(path, newline="") as fp:
        text = fp.read()
    if text and not text.endswith("\n"):
        text = text[:text.rfind("\n") + 1] if "\n" in text else ""
    rows = []
    for r in csv.DictReader(io.StringIO(text)):
        try:
            if any(v is None for v in r.values()) or None in r:
                break
            float(r["val_nf_f1_mean"])  # 'nan' parses; torn text won't
        except (ValueError, KeyError):
            break
        rows.append(r)
    return rows


def write_rows(path, rows):
    """Atomic tmp+rename rewrite, so that a reader or a restart never sees
    a header-only or rows-missing file."""
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    os.replace(tmp, path)


def net_func(cfg):
    """The net constructor of one config: the four model axes of the search."""
    from deepcalcium_torch.models.unet2d import UNet2DS

    return functools.partial(UNet2DS, nfb=cfg["nfb"], up_mode=cfg["up_mode"],
                             drp=cfg["drp"], init_scheme=cfg["init_scheme"])


def _wrapper(cfg, cpdir, device):
    """The wrapper that trains one config. Private: a machine without h5py
    replaces it with one that hands in-memory summaries to the wrapper's
    injection points."""
    from deepcalcium_torch.models.unet_2d_summary import UNet2DSummary

    return UNet2DSummary(
        cpdir=cpdir,
        series_summary_func=scaled_summary_func(cfg["scale_mode"]),
        net_func=net_func(cfg), device=device)


def main(argv=None, space=None):
    """Run the search. ``space`` narrows or replaces ``SPACE`` (same keys):
    what ``sample`` draws from and what a CSV row is read back with."""
    from deepcalcium_torch.utils.config import checkpoints_dir

    logging.basicConfig(level=logging.INFO)
    space = SPACE if space is None else space
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_name", nargs="?", default="all_train",
                    help="Neurofinder name(s), or --paths for local HDF5s, "
                         "or 'fixtures' with --make-fixtures")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="local contract-HDF5 dataset paths (skips download)")
    ap.add_argument("--make-fixtures", type=int, default=0,
                    help="synthesize N hard fixtures instead of downloading")
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--steps-per-dispatch", type=int, default=10,
                    help="train steps a dispatch, passed to fit: one CUDA "
                         "graph of K steps on the card (must be >= 1 and "
                         "divide --steps)")
    ap.add_argument("--val-shape", type=int, default=512,
                    help="must be >= the summary image side (512 covers real "
                         "Neurofinder; fixture sweeps pass their fixture size)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=865)
    ap.add_argument("--resume", action="store_true",
                    help="keep --out's existing rows, replay (and skip) "
                         "their RNG draws, and treat --trials as the TOTAL "
                         "row target: lets a sweep accumulate across "
                         "restarts (same --seed required for the config "
                         "stream to continue, not repeat)")
    ap.add_argument("--rerun-top", type=int, default=0,
                    help="instead of sampling: re-train the top N rows of "
                         "--out at --epochs/--steps and write "
                         "<out>_topN_eE.csv (the longer-budget check of "
                         "the sweep's conclusions)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every trial trains; the default fails "
                         "without a CUDA card")
    args = ap.parse_args(argv)

    # Fail fast: fit checks this per trial, and the per-trial exception
    # guard would otherwise turn a bad flag pair into a full-length
    # all-NaN sweep.
    if (args.steps_per_dispatch < 1
            or args.steps % args.steps_per_dispatch != 0):
        ap.error(f"--steps-per-dispatch {args.steps_per_dispatch} must be "
                 f">= 1 and divide --steps {args.steps}")

    # --resume without --out would silently no-op (the default out_csv is
    # a fresh timestamped name that never exists, so nothing is loaded and
    # the RNG stream restarts at trial 0, scattering rows across CSVs).
    if args.resume and not args.out:
        ap.error("--resume requires --out (the CSV whose rows to extend)")

    # For the same reason a missing card is an error here, once, before any
    # fixture, download or trial: inside a trial it would be a NaN row.
    if args.device == "cuda":
        from deepcalcium_torch.utils.device import require_cuda

        require_cuda()

    if args.make_fixtures:
        fix_dir = os.path.join(checkpoints_dir(), "search_fixtures_r3")
        paths = make_hard_fixtures(args.make_fixtures, fix_dir,
                                   seed=args.seed)
    elif args.paths:
        paths = args.paths
    else:
        from deepcalcium_torch.data.nf import nf_load_hdf5

        paths = nf_load_hdf5(args.dataset_name, device=args.device)
    rng = np.random.default_rng(args.seed)
    out_csv = args.out or os.path.join(
        checkpoints_dir(), f"hyperparam_search_{int(time.time())}.csv")

    def run_cfg(cfg, trial, epochs, steps):
        cpdir = os.path.join(checkpoints_dir(),
                             f"search_{int(time.time())}_{trial}")
        model = _wrapper(cfg, cpdir, args.device)
        t0 = time.time()
        try:
            hist, _ = model.fit(
                paths, shape_trn=(cfg["window"], cfg["window"]),
                shape_val=(args.val_shape, args.val_shape),
                batch_size_trn=cfg["batch"],
                nb_steps_trn=steps, nb_epochs=epochs,
                learning_rate=cfg["learning_rate"], loss=cfg["loss"],
                weight_decay=cfg["weight_decay"],
                steps_per_dispatch=args.steps_per_dispatch,
                seed=args.seed + trial)
            score = max(hist["val_nf_f1_mean"])
        except Exception as e:  # a diverging config must not kill the sweep
            logging.warning("trial %d failed: %s", trial, e)
            score = float("nan")
        return {**cfg, "trial": trial, "val_nf_f1_mean": score,
                "seconds": round(time.time() - t0, 1)}

    def coerce(row):
        """CSV round-trip: restore a sampled config's native types."""
        cfg = {}
        for k, vals in space.items():
            cfg[k] = type(vals[0])(row[k]) if not isinstance(vals[0], str) \
                else row[k]
        return cfg

    if args.rerun_top:
        if not args.out:
            ap.error("--rerun-top requires --out (the CSV to rank)")
        prior = load_rows(out_csv)
        ok = [r for r in prior
              if float(r["val_nf_f1_mean"]) == float(r["val_nf_f1_mean"])]
        top = sorted(ok, key=lambda r: -float(r["val_nf_f1_mean"]))
        top = top[:args.rerun_top]
        out2 = out_csv[:-4] + f"_top{args.rerun_top}_e{args.epochs}.csv"
        done = []
        if os.path.exists(out2):  # restart-safe: skip re-run trials
            done = load_rows(out2)
        rows = list(done)
        done_trials = {int(r["trial"]) for r in done}
        for r in top:
            if int(r["trial"]) in done_trials:
                continue
            row = run_cfg(coerce(r), int(r["trial"]), args.epochs,
                          args.steps)
            rows.append(row)
            write_rows(out2, rows)
            logging.info("rerun trial %s -> %s", r["trial"],
                         row["val_nf_f1_mean"])
        print("results:", out2)
        return

    rows = []
    start = 0
    if args.resume and os.path.exists(out_csv):
        rows = load_rows(out_csv)
        start = len(rows)
        for _ in range(start):  # replay consumed draws -> stream continues
            sample(rng, space)
        logging.info("resuming at trial %d (target %d)", start, args.trials)

    for trial in range(start, args.trials):
        cfg = sample(rng, space)
        row = run_cfg(cfg, trial, args.epochs, args.steps)
        rows.append(row)
        write_rows(out_csv, rows)
        logging.info("trial %d: %s -> %s", trial, cfg,
                     row["val_nf_f1_mean"])

    # Resumed rows arrive as strings: compare numerically either way.
    scored = [(float(r["val_nf_f1_mean"]), r) for r in rows]
    best = max((sr for sr in scored if sr[0] == sr[0]),
               key=lambda sr: sr[0], default=(None, None))[1]
    print("best:", best)
    print("results:", out_csv)


if __name__ == "__main__":
    main()

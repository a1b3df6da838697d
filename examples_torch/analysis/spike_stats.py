"""Spike-dataset statistics and figures.

Counterpart of ``examples/analysis/spike_stats.py``: the spike corpus's
shape (trace/spike counts at the 80/20 split), per-trace spike-count and
spike-rate distributions, and sample trace-with-spikes figures, from any
spikes-contract HDF5 (``traces``/``spikes`` datasets + ``name`` attr). With
no input paths it synthesizes a corpus at the reference notebook's scale so
the analysis runs offline. Host work only: no model runs, so there is no
``--device``.

    python examples_torch/analysis/spike_stats.py [--paths a.hdf5 ...]
        [--out-prefix docs/spike_stats_r3] [--prop-trn 0.8]
"""

import argparse
import logging
import os
import sys

sys.path.append(".")

import numpy as np


def corpus_stats(paths, prop_trn=0.8, seed=865):
    """Per-dataset + corpus statistics dict (the notebook's cell-3 table)."""
    import h5py

    rows = []
    all_counts, all_rates = [], []
    for p in paths:
        with h5py.File(p, "r") as fp:
            name = fp.attrs["name"]
            name = name if isinstance(name, str) else name.decode()
            spikes = fp["spikes"][...]
            tlen = fp["traces"].shape[1]
        counts = spikes.sum(axis=1)
        rows.append({
            "name": name,
            "traces": int(spikes.shape[0]),
            "trace_len": int(tlen),
            "spikes": int(counts.sum()),
            "mean_spikes_per_trace": float(counts.mean()),
            "mean_rate": float(counts.mean() / tlen),
        })
        all_counts.append(counts)
        all_rates.append(counts / tlen)
    counts = np.concatenate(all_counts)
    rates = np.concatenate(all_rates)
    n = len(counts)
    # The 80/20 random split the reference trains with (its cell 3 quotes
    # counts AFTER the split: ~506 train traces, ~5.6k train spikes).
    rng = np.random.default_rng(seed)
    idxs = rng.permutation(n)
    n_trn = int(n * prop_trn)
    trn, val = idxs[:n_trn], idxs[n_trn:]
    return {
        "rows": rows,
        "total_traces": n,
        "total_spikes": int(counts.sum()),
        "split": {
            "prop_trn": prop_trn,
            "trn_traces": len(trn), "trn_spikes": int(counts[trn].sum()),
            "val_traces": len(val), "val_spikes": int(counts[val].sum()),
        },
        "spike_counts": counts,
        "spike_rates": rates,
    }


def main(argv=None):
    import h5py

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--paths", nargs="*", default=None,
                    help="spikes-contract HDF5 paths (default: synthesize "
                         "a corpus at the reference notebook's scale)")
    ap.add_argument("--out-prefix", default="docs/spike_stats_r3")
    ap.add_argument("--prop-trn", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=865)
    args = ap.parse_args(argv)

    paths = args.paths
    if not paths:
        # Reference scale: ~633 total traces so the 80% split lands near
        # the notebook's ~506 train traces; rate tuned so total spikes are
        # ~7k (5.6k at 80%).
        from deepcalcium_torch.data.fixtures import make_spikes_hdf5
        from deepcalcium_torch.utils.config import datasets_dir

        d = os.path.join(datasets_dir(), "spike_stats_fixture")
        paths = [
            make_spikes_hdf5(os.path.join(d, f"sj.{i:02d}.hdf5"),
                             name=f"sj.synthetic.{i:02d}",
                             nb_traces=127 if i else 125, trace_len=2000,
                             spike_rate=0.0055, seed=100 + i)
            for i in range(5)
        ]
        logging.info("synthesized %d datasets under %s", len(paths), d)

    st = corpus_stats(paths, prop_trn=args.prop_trn, seed=args.seed)

    lines = [
        f"{'dataset':24s} {'traces':>7s} {'len':>6s} {'spikes':>7s} "
        f"{'spk/trace':>10s} {'rate':>8s}"
    ]
    for r in st["rows"]:
        lines.append(f"{r['name']:24s} {r['traces']:7d} {r['trace_len']:6d} "
                     f"{r['spikes']:7d} {r['mean_spikes_per_trace']:10.2f} "
                     f"{r['mean_rate']:8.4f}")
    sp = st["split"]
    lines += [
        "",
        f"corpus: {st['total_traces']} traces, {st['total_spikes']} spikes",
        f"{sp['prop_trn']:.0%} split: {sp['trn_traces']} train traces / "
        f"{sp['trn_spikes']} train spikes; {sp['val_traces']} val traces / "
        f"{sp['val_spikes']} val spikes",
        f"(reference suli_figures.ipynb cell 3: ~506 train traces, "
        f"~5.6k train spikes)",
        "",
        "spike-count distribution (per trace): "
        f"min={st['spike_counts'].min()} "
        f"p25={np.percentile(st['spike_counts'], 25):.0f} "
        f"median={np.median(st['spike_counts']):.0f} "
        f"p75={np.percentile(st['spike_counts'], 75):.0f} "
        f"max={st['spike_counts'].max()}",
        "spike-rate distribution (per sample): "
        f"mean={st['spike_rates'].mean():.4f} "
        f"std={st['spike_rates'].std():.4f}",
    ]
    report = "\n".join(lines)
    print(report)
    os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
    with open(args.out_prefix + ".txt", "w") as fp:
        fp.write(report + "\n")

    # Figures: spike-count histogram + sample traces with spike markers
    # (the notebook's remaining cells).
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 2, figsize=(11, 4))
    axs[0].hist(st["spike_counts"], bins=30, color="#4878CF")
    axs[0].set_xlabel("spikes per trace")
    axs[0].set_ylabel("traces")
    axs[0].set_title("per-trace spike counts")
    axs[1].hist(st["spike_rates"], bins=30, color="#6ACC65")
    axs[1].set_xlabel("spike rate (spikes/sample)")
    axs[1].set_ylabel("traces")
    axs[1].set_title("per-trace spike rates")
    fig.tight_layout()
    fig.savefig(args.out_prefix + "_hist.png", dpi=110)
    plt.close(fig)

    from deepcalcium_torch.utils.visualization import plot_traces_spikes

    with h5py.File(paths[0], "r") as fp:
        tr = fp["traces"][:6]
        sp_ = fp["spikes"][:6]
    m = tr.mean(axis=1, keepdims=True)
    s = tr.std(axis=1, keepdims=True)
    plot_traces_spikes((tr - m) / s, spikes_true=sp_,
                       title="sample traces with labeled spikes",
                       save_path=args.out_prefix + "_samples.png")
    logging.info("wrote %s.txt / _hist.png / _samples.png", args.out_prefix)


if __name__ == "__main__":
    main()

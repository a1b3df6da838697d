"""Training observability: CSV metric logging and metric-grid plots.

A copy of ``deepcalcium_tpu.train.callbacks`` (that module is plain Python,
but the port imports nothing of the JAX package). matplotlib stays
optional, as it is there: without it the plot is skipped with a warning.
"""

import csv
import logging
import math
import os

__all__ = ["CSVMetricsLogger", "plot_metrics_grid"]


class CSVMetricsLogger:
    """Append one row of metrics per epoch; header from the first row."""

    def __init__(self, path: str):
        self.path = path
        self._keys = None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.history: dict[str, list] = {}

    def append(self, epoch: int, metrics: dict) -> None:
        row = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        new = self._keys is None
        if new:
            self._keys = list(row.keys())
        with open(self.path, "a", newline="") as fp:
            w = csv.DictWriter(fp, fieldnames=self._keys, extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)
        for k, v in row.items():
            self.history.setdefault(k, []).append(v)


def plot_metrics_grid(history: dict, png_path: str, title: str = "") -> None:
    """Grid of per-metric line plots (reference keras_helpers.py:102-119)."""
    try:
        import matplotlib

        matplotlib.use("agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - headless envs without mpl
        logging.getLogger(__name__).warning("matplotlib unavailable; skip plot")
        return

    keys = [k for k in sorted(history.keys()) if k != "epoch"]
    if not keys:
        return
    nb_col = 5
    nb_row = int(math.ceil(len(keys) / nb_col))
    fig, axes = plt.subplots(
        nb_row, nb_col, figsize=(min(nb_col * 3, 15), 3 * nb_row), squeeze=False
    )
    flat = [ax for row in axes for ax in row]
    for idx, ax in enumerate(flat):
        if idx >= len(keys):
            ax.axis("off")
            continue
        k = keys[idx]
        ax.set_title(k, fontsize=8)
        ax.plot(history[k])
        ax.tick_params(labelsize=7)
    if title:
        plt.suptitle(title)
    plt.tight_layout()
    plt.savefig(png_path, dpi=120)
    plt.close(fig)

"""Outlined masks as RGB images, PNG output, and trace plots.

Port of ``mask_outlines``, ``save_png`` and ``plot_traces_spikes`` of
``deepcalcium_tpu.utils.visualization``: the base image clipped at its 99th
percentile and scaled to [0, 1], with each mask's 1-px outline (the mask
minus its 3x3 erosion) drawn over it in its colour; and one subplot per
calcium trace with its true and predicted spikes. PIL is imported only by
``save_png`` and matplotlib only by ``plot_traces_spikes``.
"""

import numpy as np
from scipy import ndimage

__all__ = ["mask_outlines", "save_png", "plot_traces_spikes"]

_COLORS = {
    "red": (1.0, 0.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "blue": (0.0, 0.3, 1.0),
    "cyan": (0.4, 1.0, 1.0),
    "white": (1.0, 1.0, 1.0),
    "yellow": (1.0, 1.0, 0.0),
}


def _outline(mask: np.ndarray) -> np.ndarray:
    """1-px boundary of a binary mask (mask minus erosion)."""
    m = np.asarray(mask) > 0
    er = ndimage.binary_erosion(m, structure=np.ones((3, 3)))
    return m & ~er


def mask_outlines(img: np.ndarray, mask_arrs=(), colors=()) -> np.ndarray:
    """Base image with coloured outlines for each mask; uint8 RGB (H, W, 3).
    An unknown colour name draws in red."""
    if len(mask_arrs) != len(colors):
        raise ValueError(f"one colour per mask: {len(mask_arrs)} masks, "
                         f"{len(colors)} colours")
    img = np.asarray(img, np.float32)
    hi = np.percentile(img, 99)
    img = np.clip(img, img.min(), hi)
    rng = img.max() - img.min()
    img = (img - img.min()) / (rng if rng > 0 else 1.0)
    rgb = np.stack([img] * 3, axis=-1)

    oln = np.zeros_like(rgb)
    for m, c in zip(mask_arrs, colors):
        if np.sum(m) == 0:
            continue
        oln[_outline(m)] = np.array(_COLORS.get(c, _COLORS["red"]), np.float32)

    oln_msk = oln.max(axis=-1, keepdims=True)
    merged = oln * oln_msk + rgb * (1.0 - oln_msk)
    return (np.clip(merged, 0, 1) * 255).astype(np.uint8)


def save_png(path: str, arr: np.ndarray) -> None:
    """Save a (H, W) or (H, W, 3) array as PNG; a non-uint8 array is read
    as values in [0, 1]."""
    from PIL import Image

    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(a).save(path)


def plot_traces_spikes(traces, spikes_true=None, spikes_pred=None, title=None,
                       save_path=None, dpi=100, fig_width=20, legend=True):
    """One subplot per trace: the trace in black, cyan dots at the true
    spikes, red segments at the predicted ones (``spikes_pred`` rounded).
    Saved to ``save_path`` when given, else shown."""
    import matplotlib

    if save_path:
        matplotlib.use("agg")
    import matplotlib.pyplot as plt

    traces = np.asarray(traces)
    n = traces.shape[0]
    fig, axes = plt.subplots(n, 1, figsize=(fig_width, n * 1.7), squeeze=False)
    axes = [ax for row in axes for ax in row]
    for i, ax in enumerate(axes):
        t = traces[i]
        ax.plot(t, c="k", linewidth=1.0)
        if spikes_true is not None:
            (xxt,) = np.where(np.asarray(spikes_true)[i] == 1)
            ax.scatter(xxt, t[xxt], c="cyan", marker="o", s=150, alpha=0.8,
                       label="Ground-truth spike")
        if spikes_pred is not None:
            (xx,) = np.where(np.round(np.asarray(spikes_pred)[i]) == 1)
            label = "Predicted spikes"
            for x in xx:
                x1 = min(x + 1, len(t) - 1)
                ax.plot([x, x1], t[[x, x1]], "r", label=label)
                label = None
        if legend and (i == 0 or i == n - 1):
            ax.legend(loc="lower left", ncol=3)
        ax.set_ylabel("Brightness")
        ax.set_xlabel("Time steps")
    plt.subplots_adjust(hspace=0.7)
    if title:
        plt.suptitle(title)
    if save_path:
        plt.savefig(save_path, dpi=dpi, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
    else:
        plt.show()

"""Outlined masks as RGB images, PNG output, trace plots and movie export.

Port of ``deepcalcium_tpu.utils.visualization`` (``mask_outlines``,
``save_png``, ``plot_traces_spikes``, ``dataset_to_mp4``): the base image
clipped at its 99th percentile and scaled to [0, 1], with each mask's 1-px
outline (the mask minus its 3x3 erosion) drawn over it in its colour; and
one subplot per calcium trace with its true and predicted spikes. PIL is imported only by
``save_png`` and matplotlib only by ``plot_traces_spikes``;
``dataset_to_mp4`` burns cyan neuron outlines into a grayscale movie and
writes it with imageio when that is installed.
"""

import logging
import os

import numpy as np
from scipy import ndimage

__all__ = ["mask_outlines", "save_png", "plot_traces_spikes",
           "dataset_to_mp4"]

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


def dataset_to_mp4(s, m, mp4_path):
    """Export a (T, H, W) movie ``s`` scaled to 0..255, with the outlines of
    the (N, H, W) masks ``m`` (or None) in cyan.

    Written with imageio's ffmpeg writer when present; else as an animated
    GIF beside ``mp4_path``; else, without imageio, as about 100 PNG frames
    under ``<mp4_path>.frames/``.
    """
    logger = logging.getLogger(__name__)
    s = np.asarray(s, np.float32)
    s = (s - s.min()) / max(s.max() - s.min(), 1e-9) * 255

    # Cast before replicating to RGB: the float32 movie repeated three
    # times would take four times the memory of the uint8 one.
    video = np.repeat(s.astype(np.uint8)[..., None], 3, axis=-1)
    if m is not None:
        edges = np.zeros(s.shape[1:], bool)
        for i in range(m.shape[0]):
            edges |= _outline(m[i])
        video[:, edges, :] = np.array([102, 255, 255], np.uint8)

    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        gif_path = os.path.splitext(mp4_path)[0] + ".gif"
        for path, kw, log in (
                (mp4_path, {"fps": 30}, "Saved video %s"),
                (gif_path, {"duration": 1000 / 30, "loop": 0},
                 "No mp4 codec available; saved GIF %s instead")):
            try:
                imageio.mimwrite(path, video, **kw)
            except Exception as e:  # a missing codec or plugin: next writer
                logger.info("imageio could not write %s (%s)", path, e)
                continue
            logger.info(log, path)
            return
    frames_dir = mp4_path + ".frames"
    os.makedirs(frames_dir, exist_ok=True)
    step = max(1, len(video) // 100)
    for i in range(0, len(video), step):
        save_png(os.path.join(frames_dir, f"frame_{i:06d}.png"), video[i])
    logger.warning(
        "No video writer available; wrote every %dth frame (%d PNGs of %d "
        "total) to %s", step, -(-len(video) // step), len(video), frames_dir)

"""Outlined masks as RGB images, and PNG output.

Port of ``mask_outlines`` and ``save_png`` of
``deepcalcium_tpu.utils.visualization``: the base image clipped at its 99th
percentile and scaled to [0, 1], with each mask's 1-px outline (the mask
minus its 3x3 erosion) drawn over it in its colour. PIL is imported only by
``save_png``.
"""

import numpy as np
from scipy import ndimage

__all__ = ["mask_outlines", "save_png"]

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
